"""What crosses between the JAX package and the port: data, structure
and weights.

The stream system has no weights. Its inputs are SPD text, Append_Reg
values and initial states; :func:`from_numpy` moves a state onto a device,
and :func:`core_structure` renders a parsed ``Core`` as plain Python so
the two packages' parsers can be compared without importing each other.
The LM substrate's weights cross as numpy arrays: :func:`params_from_jax`
loads a JAX parameter tree into the port's ``Transformer``, ``Zamba2`` or
``XLSTM``, and :func:`param_tree` is the inverse view, a model's
parameters as the reference's nested tree, which the train step
differentiates and the checkpoints store (docs/port.md §train).
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device without a card raises.

    The port's entry points default to ``"cuda"`` and never fall back to
    the CPU quietly: pass ``device="cpu"`` to run the plain versions.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain torch versions"
        )
    if dev.type == "cuda" and dev.index is not None:
        n = torch.cuda.device_count()
        if dev.index >= n:
            raise RuntimeError(
                f"no CUDA device {dev}: this machine has {n} card(s); pass "
                "an index below that, or device='cpu' to run the port's "
                "plain torch versions"
            )
    return dev


def resolve_devices(devices, d: int) -> list:
    """The ``d`` devices of a mesh, as ``torch.device``s.

    ``None`` takes ``cuda:0 … cuda:d-1`` and raises when fewer cards are
    present. An explicit list may repeat a device — ``["cuda:0"] * 4``
    runs four shards on one card, ``["cpu"] * 4`` on the CPU, the
    counterpart of XLA's forced host devices — but may not mix the CPU
    and CUDA. ``ValueError`` when the list holds fewer than ``d``.
    """
    d = int(d)
    if d < 1:
        raise ValueError(f"device axis must be >= 1, got d={d}")
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < d:
            raise ValueError(
                f"need {d} devices, have {n} CUDA card(s); pass an explicit "
                f"device list that repeats a device, e.g. ['cuda:0'] * {d} "
                "(the counterpart of XLA's forced host devices)"
            )
        return [torch.device("cuda", i) for i in range(d)]
    devs = [resolve_device(x) for x in devices]
    if len(devs) < d:
        raise ValueError(f"need {d} devices, have {len(devs)} in the list")
    devs = [torch.device("cuda", torch.cuda.current_device())
            if x.type == "cuda" and x.index is None else x
            for x in devs[:d]]
    if len({x.type for x in devs}) > 1:
        raise ValueError(
            f"a device list may not mix the CPU and CUDA: {devs}"
        )
    return devs


def from_numpy(x, device) -> torch.Tensor:
    """A contiguous f32 tensor of ``x`` (numpy, sequence or tensor) on
    ``device``."""
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32).contiguous()
    return torch.tensor(np.asarray(x, dtype=np.float32), device=dev)


def core_structure(core) -> tuple:
    """A parsed ``Core`` as a nested tuple of plain Python values: name,
    ports, regs, params, nodes (kind, module, inputs, outputs, params,
    delay, expression repr) and DRCT lines. Works on either package's
    ``Core`` (their dataclasses share field names and reprs)."""
    return (
        core.name,
        tuple((i.name, tuple(i.ports)) for i in core.main_in),
        tuple((i.name, tuple(i.ports)) for i in core.main_out),
        tuple((i.name, tuple(i.ports)) for i in core.brch_in),
        tuple((i.name, tuple(i.ports)) for i in core.brch_out),
        tuple(core.regs),
        tuple(sorted(core.params.items())),
        tuple(
            (n.name, n.kind, n.module, tuple(n.inputs), tuple(n.outputs),
             tuple(n.params), n.delay, repr(n.expr))
            for n in core.nodes
        ),
        tuple((tuple(d), tuple(s)) for d, s in core.drcts),
    )


class Stacked:
    """One stacked leaf of the reference's parameter tree, an ``(L, ...)``
    array, held as the ``L`` per-layer tensors of the port's modules
    (``parts``, no copy). It has the stacked leaf's ``shape``, ``ndim``,
    ``dtype`` and ``device``: the optimizer decays it by the stacked
    ``ndim`` (a stacked norm is a matrix there, as in the reference), and
    a checkpoint stores it stacked."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = list(parts)

    @property
    def shape(self) -> tuple:
        return (len(self.parts),) + tuple(self.parts[0].shape)

    @property
    def ndim(self) -> int:
        return 1 + self.parts[0].dim()

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self):
        return self.parts[0].device

    def stack(self) -> torch.Tensor:
        """A stacked copy."""
        return torch.stack([p.detach() for p in self.parts])

    @torch.no_grad()
    def copy_(self, src) -> "Stacked":
        """Each part from its row of the stacked tensor ``src``."""
        for i, p in enumerate(self.parts):
            p.copy_(src[i])
        return self


def leaf_parts(leaf) -> list:
    """The tensors a leaf of a parameter tree holds: a :class:`Stacked`
    leaf's per-layer parts, or the leaf itself."""
    return leaf.parts if isinstance(leaf, Stacked) else [leaf]


def _own(module) -> dict:
    """A module's parameters as a nested dict: its own by name, each
    child's under the child's name."""
    out = dict(module.named_parameters(recurse=False))
    for name, child in module.named_children():
        out[name] = _own(child)
    return out


def _stacked(modules) -> dict:
    """Modules of one kind as the reference's stacked subtree, each leaf a
    :class:`Stacked` of the modules' tensors."""
    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return Stacked(nodes)

    return stack([_own(m) for m in modules])


def param_tree(model) -> dict:
    """``model``'s parameters as the reference's ``init_params`` tree:
    the same keys and nesting, each leaf the module's own tensor. The
    xLSTM ``blocks`` list holds one dict per block; the stacked groups of
    the others (``layers``, ``moe_layers``, ``enc_layers``,
    ``dec_layers``, ``mamba_layers``) hold :class:`Stacked` leaves. A
    config with Kimi Delta Attention stacks its KDA layers apart, as
    ``kda_layers`` (dense) and ``kda_moe_layers``, each group in the
    layers' order."""
    from repro_torch.models.registry import XLSTM
    from repro_torch.models.zamba2 import Zamba2

    cfg = model.cfg
    tree = {"embed": model.embed, "ln_f": model.ln_f}
    if not cfg.tie_embeddings:
        tree["lm_head"] = model.lm_head
    if isinstance(model, XLSTM):
        tree["blocks"] = [_own(block) for block in model.blocks]
    elif isinstance(model, Zamba2):
        tree["mamba_layers"] = _stacked(model.layers)
        tree["shared_attn"] = _own(model.shared)
    elif cfg.enc_dec:
        tree["enc_layers"] = _stacked(model.enc_layers)
        tree["dec_layers"] = _stacked(model.dec_layers)
        tree["ln_enc"] = model.ln_enc
    else:
        n_dense = cfg.moe.moe_start_layer if cfg.moe else cfg.n_layers
        groups: dict[str, list] = {}
        for i, layer in enumerate(model.layers):
            key = (("kda_" if cfg.is_kda(i) else "")
                   + ("layers" if i < n_dense else "moe_layers"))
            groups.setdefault(key, []).append(layer)
        tree.update({k: _stacked(v) for k, v in groups.items()})
    return tree


def params_from_jax(tree, cfg, device):
    """The port's model of ``cfg`` on ``device`` holding the weights of a
    JAX parameter tree: a ``Transformer`` for the dense family, a
    ``Zamba2`` for the hybrid one, an ``XLSTM`` for the SSM one.

    ``tree`` is the JAX package's ``init_params`` tree with every leaf a
    numpy array: ``embed``, ``ln_f``, ``lm_head`` (unless tied), and
    ``layers`` (dense, VLM), ``moe_layers`` after the dense head
    ``layers``, if any (MoE: ``moe.router``, ``moe.w_gate``, ``moe.w_up``,
    ``moe.w_down`` and an optional ``moe.shared``), ``enc_layers`` (each
    a dense layer), ``dec_layers`` (each with ``ln_x`` and ``xattn``
    besides) and ``ln_enc`` (encoder-decoder), ``mamba_layers`` and the
    one ``shared_attn`` block (hybrid), or ``blocks``, a list of one
    mLSTM or sLSTM dict per block (SSM). Stacked leaves carry the ``L``
    axis first. Matrices are ``(d_in, d_out)`` in both packages, so
    nothing is transposed. Other trees raise.
    """
    from repro_torch.models.registry import XLSTM
    from repro_torch.models.transformer import Transformer
    from repro_torch.models.zamba2 import Zamba2

    dev = resolve_device(device)
    if not ("layers" in tree or "moe_layers" in tree
            or "mamba_layers" in tree or "enc_layers" in tree
            or "blocks" in tree):
        raise NotImplementedError("only the decoder-only trees (``layers``, "
                                  "``moe_layers``), the encoder-decoder "
                                  "tree (``enc_layers``, ``dec_layers``), "
                                  "the hybrid tree (``mamba_layers``) and "
                                  "the xLSTM tree (``blocks``) are ported")

    def put(param, value):
        value = np.asarray(value)
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"shape {value.shape} != {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.array(value, np.float32)))

    def put_block(module, block, i=None):
        """A (nested) block of the tree into the module whose attributes
        carry its keys (a decoder block: norms, ``attn``, ``mlp`` or
        ``moe``); ``i`` indexes a stacked tree."""
        for name, value in block.items():
            if isinstance(value, dict):
                put_block(getattr(module, name), value, i)
            else:
                put(getattr(module, name), value if i is None else value[i])

    hybrid = "mamba_layers" in tree
    ssm = "blocks" in tree
    model = (Zamba2 if hybrid else XLSTM if ssm else Transformer)(
        cfg, device=dev)
    put(model.embed, tree["embed"])
    put(model.ln_f, tree["ln_f"])
    if not cfg.tie_embeddings:
        put(model.lm_head, tree["lm_head"])
    if ssm:
        for block, value in zip(model.blocks, tree["blocks"], strict=True):
            put_block(block, value)
    elif hybrid:
        for i, layer in enumerate(model.layers):
            for name, value in tree["mamba_layers"].items():
                put(getattr(layer, name), value[i])
        put_block(model.shared, tree["shared_attn"])
    elif "enc_layers" in tree:
        put(model.ln_enc, tree["ln_enc"])
        for i in range(cfg.n_layers):
            put_block(model.enc_layers[i], tree["enc_layers"], i)
            put_block(model.dec_layers[i], tree["dec_layers"], i)
    else:
        n_dense = len(tree["layers"]["ln1"]) if "layers" in tree else 0
        for i, layer in enumerate(model.layers):
            if i < n_dense:
                put_block(layer, tree["layers"], i)
            else:
                put_block(layer, tree["moe_layers"], i - n_dense)
    return model
