"""Batched serving engine: continuous batching over a fixed-slot KV cache
(the port of the JAX package's ``serve/engine.py``).

Requests enter a queue; up to ``max_batch`` occupy cache slots. Each tick
decodes one token for every active slot, one full-batch ``decode_step`` per
slot. A freshly admitted prompt is replayed into its slot's cache through
the decode path, slots with equal replay lengths in lockstep (one
full-batch step per prompt position). Sampling is greedy, or at a
temperature from a seeded ``torch.Generator``.

One deliberate difference from the reference: every step passes the slots
it steps as ``rows`` to ``decode_step``, so a call writes K/V (and a
hybrid's SSM state) only into those slots' cache rows. The reference's
full-batch step writes every row at the stepped position, and with two
slots at one position the second slot's step overwrites the first slot's
entry with token 0's K/V (ROADMAP Queue 3). A request's first step is at
position 0, where the hybrid's ``decode_step`` starts the stepped rows
from a zero SSM state (docs/port.md §hybrid) and ``xlstm_decode`` from
the xLSTM's state-init values (docs/port.md §ssm). For an MoE model the same
``rows`` make a step dispatch only the live rows it advances, so the
expert capacity counts those rows' tokens; the reference's full-batch
step dispatches every slot, idle ones included (docs/port.md §moe). An
encoder-decoder bundle is refused: the reference's engine takes no frames
and decodes whisper against the zeroed cross cache of ``init_cache``
(docs/port.md §encdec).
"""

from __future__ import annotations

import queue
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.models.registry import ModelBundle


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    temperature: float = 0.0


@dataclass
class Completion:
    rid: int
    tokens: list[int]


class ServeEngine:
    def __init__(self, bundle: ModelBundle, params: Any, *, max_batch: int,
                 max_seq: int, seed: int = 0):
        if bundle.cfg.enc_dec:
            raise NotImplementedError(
                f"{bundle.cfg.name}: the engine serves decoder-only models. "
                "A request here carries no frames, so an encoder-decoder "
                "model's cross-attention cache would never be primed; decode "
                "it through prime_cross_cache and decode_step_enc_dec "
                "(docs/port.md §encdec)"
            )
        self.bundle = bundle
        self.cfg = bundle.cfg
        self.device = bundle.device
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.cache = bundle.cache_init(max_batch, max_seq)
        self._decode = bundle.make_decode_step()
        self.rng = torch.Generator().manual_seed(seed)
        self.queue: "queue.Queue[Request]" = queue.Queue()
        #: full-batch decode steps issued (replay and ticks)
        self.decode_calls = 0
        # slot bookkeeping (host side)
        self.slot_req: list[Request | None] = [None] * max_batch
        self.slot_pos: list[int] = [0] * max_batch
        self.slot_out: list[list[int]] = [[] for _ in range(max_batch)]
        self.slot_last: list[int] = [0] * max_batch

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.put(req)

    def _admit(self) -> None:
        new: list[int] = []
        for slot in range(self.max_batch):
            if self.slot_req[slot] is not None:
                continue
            try:
                req = self.queue.get_nowait()
            except queue.Empty:
                break
            self.slot_req[slot] = req
            self.slot_pos[slot] = 0
            self.slot_out[slot] = []
            self.slot_last[slot] = req.prompt[-1]
            new.append(slot)
        if new:
            self._replay_prompts(new)

    def _step(self, tokens: dict[int, int], pos: int, rows: list[int]):
        """One full-batch decode at ``pos`` writing K/V into ``rows``."""
        token = torch.zeros((self.max_batch, 1), dtype=torch.int64)
        for slot, tok in tokens.items():
            token[slot, 0] = tok
        logits, self.cache = self._decode(
            self.params, token.to(self.device), self.cache, pos, rows)
        self.decode_calls += 1
        return logits

    def _replay_prompts(self, slots: list[int]) -> None:
        """Cache-building prefill for freshly admitted slots: slots that
        replay the same number of prompt tokens advance in lockstep, one
        full-batch step per prompt position carrying every group member's
        token and writing only the group's rows."""
        by_len: dict[int, list[int]] = {}
        for slot in slots:
            n = len(self.slot_req[slot].prompt) - 1
            if n > 0:
                by_len.setdefault(n, []).append(slot)
        for n, group in sorted(by_len.items()):
            for t in range(n):
                self._step({s: self.slot_req[s].prompt[t] for s in group},
                           t, group)
                for slot in group:
                    self.slot_pos[slot] = t + 1

    def _step_slot(self, slot: int, tok: int) -> torch.Tensor:
        """Advance one slot by one token; its next-token logits, f32 on
        the host."""
        logits = self._step({slot: tok}, self.slot_pos[slot], [slot])
        self.slot_pos[slot] += 1
        return logits[slot, 0].float().cpu()

    def _sample(self, logits: torch.Tensor, req: Request) -> int:
        if req.temperature > 0:
            z = logits.double() / req.temperature
            p = torch.softmax(z - z.max(), dim=-1)
            return int(torch.multinomial(p, 1, generator=self.rng))
        return int(torch.argmax(logits))

    # ------------------------------------------------------------------
    def step(self) -> list[Completion]:
        """One engine tick: admit, decode one token for every active slot,
        retire finished requests."""
        self._admit()
        active = [s for s in range(self.max_batch) if self.slot_req[s]]
        done: list[Completion] = []
        for slot in active:
            logits = self._step_slot(slot, self.slot_last[slot])
            req = self.slot_req[slot]
            nxt = self._sample(logits, req)
            self.slot_out[slot].append(nxt)
            self.slot_last[slot] = nxt
            if (
                len(self.slot_out[slot]) >= req.max_new_tokens
                or self.slot_pos[slot] >= self.max_seq - 1
            ):
                done.append(Completion(req.rid, list(self.slot_out[slot])))
                self.slot_req[slot] = None
        return done

    def run_until_drained(self, max_ticks: int = 10_000) -> list[Completion]:
        """Tick until every queued and in-flight request completes.

        ``max_ticks`` bounds the loop; hitting the bound with work still
        pending raises ``RuntimeError`` naming the undrained request ids
        rather than returning a partial completion list.
        """
        out: list[Completion] = []
        for _ in range(max_ticks):
            out.extend(self.step())
            if self.queue.empty() and all(r is None for r in self.slot_req):
                return out
        undrained = [r.rid for r in self.slot_req if r is not None]
        undrained += [r.rid for r in list(self.queue.queue)]
        raise RuntimeError(
            f"run_until_drained hit max_ticks={max_ticks} with "
            f"{len(undrained)} request(s) undrained (rids {undrained}); "
            f"{len(out)} completion(s) were produced before the bound"
        )
