"""Batched serving engine with continuous batching.

A fixed pool of ``n_slots`` decode slots runs one decode step per tick
over the *whole* pool: finished or empty slots decode a pad token and
are masked out; new requests are admitted into free slots between ticks
by resetting that slot's cache rows to their fresh values.  A prompt is
force-fed one token per tick through the same decode step.  The vision
and audio families take a per-slot ``ctx`` (patch or frame embeddings),
turned into the cross K/V once, at construction, and kept across
admissions.

Slot admission itself (a FIFO queue over a fixed slot pool) is factored
into `SlotPool`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.platform import resolve_device
from repro_torch.models.registry import ModelApi


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list          # token ids
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class SlotPool:
    """FIFO admission over a fixed pool of continuous-batching slots.

    Holds arbitrary request objects: a ``None`` slot is free, anything
    else is an in-flight request.  `admit` fills free slots from the
    queue in submission order and reports the ``(slot, request)`` pairs
    it placed, so the caller can run its per-admission setup.
    """

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self.slots: list = [None] * n_slots
        self.queue: list = []

    def submit(self, req) -> None:
        self.queue.append(req)

    def admit(self) -> list:
        """Fill free slots FIFO; returns the new ``(slot, req)`` pairs."""
        placed = []
        for s in range(self.n_slots):
            if self.slots[s] is None and self.queue:
                req = self.queue.pop(0)
                self.slots[s] = req
                placed.append((s, req))
        return placed

    def free(self, s: int) -> None:
        self.slots[s] = None

    def active(self) -> list:
        """In-flight ``(slot, req)`` pairs, slot order."""
        return [(s, r) for s, r in enumerate(self.slots) if r is not None]

    def pending(self) -> bool:
        """True while anything is queued or in flight."""
        return bool(self.queue) or any(r is not None for r in self.slots)


def _slot_fills(fresh, axes):
    """Per leaf that a slot reset touches (its batch axis not ``None``):
    ``(batch axis, the constant `init_cache` fills it with)``, from a
    small fresh cache ``fresh``."""
    out = {}
    for k, ax in axes.items():
        if isinstance(ax, dict):
            out[k] = _slot_fills(fresh[k], ax)
        elif ax is not None:
            value = fresh[k].flatten()[0]
            if not bool((fresh[k] == value).all()):
                raise ValueError(f"cache leaf {k!r} is not one constant "
                                 f"at init")
            out[k] = (ax, value.item())
    return out


class Engine:
    """Greedy continuous batching over ``api.decode`` on one device.

    ``params`` must already lie on ``device`` (the card unless
    ``device="cpu"``); the cache is made there and updated in place.
    ``ctx`` (n_slots, n_ctx_tokens, d_model), required where
    ``api.needs_ctx``, gives each slot its context.
    """

    def __init__(self, api: ModelApi, params, *, n_slots: int = 4,
                 max_seq: int = 256, ctx=None, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        leaf = params["embed"]["tok"]
        if leaf.device != self.device:
            raise ValueError(f"params are on {leaf.device}, the engine "
                             f"serves on {self.device}")
        self.api = api
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.cache = api.init_cache(n_slots, max_seq, device=self.device)
        if api.needs_ctx:
            if ctx is None:
                raise ValueError(f"{api.cfg.name} needs a ctx of "
                                 f"({n_slots}, {api.cfg.n_ctx_tokens}, "
                                 f"{api.cfg.d_model})")
            self.cache = api.fill_ctx(params, self.cache, ctx)
        elif ctx is not None:
            raise ValueError(f"{api.cfg.name} ({api.cfg.family}) takes no "
                             f"ctx")
        self._fills = _slot_fills(api.init_cache(1, 1, device="cpu"),
                                  api.batch_axes())
        self.pool = SlotPool(n_slots)
        self.last_tok = np.zeros((n_slots,), np.int32)
        self._remaining_prompt: list[list] = [[] for _ in range(n_slots)]

    @property
    def slots(self) -> list:
        return self.pool.slots

    @property
    def queue(self) -> list:
        return self.pool.queue

    # -- admission ---------------------------------------------------------

    def submit(self, req: Request):
        if not req.prompt:
            raise ValueError(
                f"request {req.rid}: empty prompt (admission would have "
                "no token to feed)")
        if req.max_new < 1:
            raise ValueError(
                f"request {req.rid}: max_new must be >= 1, got "
                f"{req.max_new}")
        self.pool.submit(req)

    def _reset_slot(self, s: int):
        """Reset slot s in place to the cache `init_cache` makes: every
        leaf along its batch axis (KV rows, recurrent states and their
        stabilisers, ``length``), except the cross K/V made from the
        slot's context, which stays the slot's."""
        def reset(tree, fills):
            for k, f in fills.items():
                if isinstance(f, dict):
                    reset(tree[k], f)
                else:
                    tree[k].select(f[0], s).fill_(f[1])

        reset(self.cache, self._fills)
    def _admit(self):
        for s, req in self.pool.admit():
            self._reset_slot(s)
            self.last_tok[s] = req.prompt[0]
            self._remaining_prompt[s] = list(req.prompt[1:])

    # -- decode tick ---------------------------------------------------------

    def tick(self) -> list[Request]:
        """One decode step over the slot pool; returns requests that
        completed on this tick (admission included: a one-token prompt
        with ``max_new=1`` completes on its admission tick)."""
        self._admit()
        toks = torch.tensor(self.last_tok, device=self.device)
        logits, self.cache = self.api.decode(self.params, self.cache, toks)
        # argmax takes the lowest index among equal maxima
        nxt = logits.argmax(-1).to(torch.int32).cpu().numpy()
        completed = []
        for s, req in enumerate(self.pool.slots):
            if req is None:
                continue
            if self._remaining_prompt[s]:
                # still force-feeding the prompt
                self.last_tok[s] = self._remaining_prompt[s].pop(0)
                continue
            req.out.append(int(nxt[s]))
            self.last_tok[s] = nxt[s]
            if len(req.out) >= req.max_new:
                req.done = True
                self.pool.free(s)
                completed.append(req)
        return completed

    def run(self, max_ticks: int = 1000) -> list[Request]:
        """Tick until drained or ``max_ticks``; returns finished requests.

        Hitting ``max_ticks`` is not an error: in-flight requests keep
        their partial ``out`` and queued requests stay queued, so a
        subsequent `run` (or `tick`) call resumes exactly where this
        one stopped.
        """
        done = []
        ticks = 0
        while self.pool.pending() and ticks < max_ticks:
            done.extend(self.tick())
            ticks += 1
        return done
