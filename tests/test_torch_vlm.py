"""The port's VLM family (LLaVA-NeXT-34B, reduced: 2 layers, d_model 128,
GQA 4:2, 8 frontend embeddings) against the JAX package on the CPU.

The VLM is the dense bundle with the frontend's patch embeddings
prepended to the tokens (docs/port.md §vlm). f32 throughout; the
tolerances are the dense model's (tests/test_torch_lm.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeConfig as JaxShape
from repro.models import registry as jreg
from repro.models import transformer as jt
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.interop import params_from_jax
from repro_torch.models import registry
from repro_torch.serve.engine import Request, ServeEngine

#: Logits after two layers and the head, f32.
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _llava():
    jc = jax_get_arch("llava-next-34b").reduced()
    tc = get_arch("llava-next-34b").reduced()
    params = jax.jit(lambda k: jt.init_params(jc, k))(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jc, tc, params, params_from_jax(tree, tc, "cpu")


def test_forward_with_embeds_matches_reference():
    """The bundle's forward on ``make_batch``'s prefill batch (8 embeds,
    24 tokens) equals ``tfm.forward`` on the reference's batch of the same
    seed, every position, the frontend's included."""
    jc, tc, params, model = _llava()
    batch = registry.make_batch(tc, ShapeConfig("p", 32, 2, "prefill"),
                                seed=3, device="cpu")
    jbatch = jreg.make_batch(jc, JaxShape("p", 32, 2, "prefill"), seed=3)
    got = registry.build(tc, device="cpu").forward(model, batch)
    want = jax.jit(jt.forward, static_argnums=1)(
        params, jc, jbatch["tokens"], jbatch["embeds"])
    assert got.shape == (2, 32, tc.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_prefill_step_with_embeds_matches_reference():
    jc, tc, params, model = _llava()
    batch = registry.make_batch(tc, ShapeConfig("p", 24, 3, "prefill"),
                                seed=4, device="cpu")
    jbatch = jreg.make_batch(jc, JaxShape("p", 24, 3, "prefill"), seed=4)
    got = registry.build(tc, device="cpu").make_prefill_step()(model, batch)
    want = jax.jit(jreg.build(jc).make_prefill_step())(params, jbatch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_engine_serves_text_prompts_as_the_greedy_forward():
    """Decode without embeds, as the reference tests it
    (tests/test_archs.py): the engine's greedy tokens on text prompts at
    max_batch 2, with a re-used slot, equal the argmax of the forward."""
    _, tc, _, model = _llava()
    bundle = registry.build(tc, device="cpu")
    prompts = [[5, 17, 31], [7, 2, 44, 9], [9, 3]]
    eng = ServeEngine(bundle, model, max_batch=2, max_seq=32)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=list(p), max_new_tokens=4))
    done = {c.rid: c.tokens for c in eng.run_until_drained()}
    for rid, p in enumerate(prompts):
        seq = list(p)
        for t in done[rid]:
            logits = bundle.forward(model, {"tokens": torch.tensor([seq])})
            assert t == int(logits[0, -1].argmax())
            seq.append(t)
