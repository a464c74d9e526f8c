"""Batched serving engine: prefill a batch of requests, then decode one token
per live slot per tick; the counterpart of ``repro.serve.engine``.

A fixed decode batch of ``batch_slots`` slots; a batch of requests is
left-padded to ``prompt_len`` and prefilled in one call, its decode state
fills the slots, and every tick decodes one token for all of them. A slot is
done at ``max_new`` tokens. Sampling is greedy, or at a temperature with an
explicit ``torch.Generator`` (seeded from ``seed``). The engine runs on the
model's device, which must be the one asked for (the CUDA card unless told
otherwise).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import Model


@dataclasses.dataclass
class Request:
    rid: int
    tokens: list[int]
    max_new: int = 32
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, model: Model, *, batch_slots: int = 4,
                 prompt_len: int = 64, temperature: float = 0.0,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"ServeEngine on {self.device} got a model on "
                             f"{model.device}")
        self.model = model
        self.b = batch_slots
        self.prompt_len = prompt_len
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state = None
        self.logits = None       # the last logits sampled from (b, vocab)
        self.slot_req: list[Request | None] = [None] * batch_slots
        self.last_tok = torch.zeros((batch_slots, 1), dtype=torch.long,
                                    device=self.device)
        self.length = 0

    # ------------------------------------------------------------- admission
    def admit(self, reqs: list[Request]):
        """Prefill a full batch of requests into the decode slots."""
        if len(reqs) > self.b:
            raise ValueError(f"{len(reqs)} requests for {self.b} slots")
        pad = self.prompt_len
        toks = torch.zeros((self.b, pad), dtype=torch.long)
        for i, r in enumerate(reqs):
            t = r.tokens[-pad:]
            toks[i, pad - len(t):] = torch.tensor(t)   # left-pad
        self.logits, self.state = self.model.prefill_fn(
            {"tokens": toks.to(self.device)})
        self.length = pad
        nxt = self._sample(self.logits)
        host = nxt.tolist()
        for i, r in enumerate(reqs):
            self.slot_req[i] = r
            r.out.append(host[i])
        self.last_tok = nxt[:, None]

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    # ------------------------------------------------------------------ tick
    def tick(self):
        """Decode one token for every live slot."""
        self.logits, self.state = self.model.decode_fn(
            self.state, self.last_tok, self.length)
        self.length += 1
        nxt = self._sample(self.logits)
        host = nxt.tolist()
        for i, r in enumerate(self.slot_req):
            if r is None or r.done:
                continue
            r.out.append(host[i])
            if len(r.out) >= r.max_new:
                r.done = True
        self.last_tok = nxt[:, None]

    def run(self, reqs: list[Request], max_ticks: int = 64):
        self.admit(reqs[: self.b])
        for _ in range(max_ticks):
            if all(r is None or r.done for r in self.slot_req):
                break
            self.tick()
        return reqs
