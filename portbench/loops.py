"""The traffic generator: one loop a traffic ``kind``, its parameters read
from the mix's file.

* ``prefill``: one client sends a prompt of ``batch`` x ``tokens`` ids
  through the port's ``make_prefill_step`` and waits for its logits before
  it sends the next (a closed loop).  Prompts cycle through a pool drawn
  from the seed.  The window lasts ``seconds`` and at least until the
  requests the check reads (drawn from its first ``drawn_from_first``)
  are in.
* ``decode``: ``sessions`` sessions decode greedily in one batch through
  the port's ``make_serve_step``, driven as ``launch.serve.serve`` drives
  it: each ``prompt_tokens``-token prompt teacher-forced into a cache of
  ``max_len`` slots, then one step a token, its argmax fed back.  The first
  batch's prompts run in set-up; when the cache fills, a new batch of
  sessions starts inside the window.  The window lasts ``seconds`` and at
  least two greedy steps.

Both loops are closed (``loop``: ``"closed"``) with one client; a mix that
asks for another loop or more clients is refused, not run as this one.
Each loop warms every shape it runs in set-up, keeps what the check reads
of the window's answers (a sample drawn from the seed before the window),
and counts the window's tokens and attention pairs for the per-layer
metrics.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StepMarks:
    """Points on the device's stream after each step: CUDA events on the
    card, the host clock after a wait elsewhere."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def ms(self, i: int, j: int) -> float:
        """Milliseconds from mark ``i`` to mark ``j`` (after a sync)."""
        if self.cuda:
            return self.marks[i].elapsed_time(self.marks[j])
        return 1e3 * (self.marks[j] - self.marks[i])


class PrefillLoop:
    def __init__(self, cfg, params, traffic, seed, device, steps):
        self.params, self.t, self.device = params, traffic, device
        self.step = steps.make_prefill_step(cfg)
        gen = torch.Generator(device=device).manual_seed(seed)
        shape = (traffic["prompt_pool"], traffic["batch"], traffic["tokens"])
        self.prompts = torch.randint(0, cfg.vocab, shape, generator=gen, device=device)
        rng = np.random.default_rng(seed)
        chk = traffic["check"]
        self.keep = sorted(rng.choice(chk["drawn_from_first"], chk["requests"], replace=False).tolist())
        self.positions = torch.as_tensor(
            np.sort(rng.choice(traffic["tokens"], chk["positions"], replace=False)), device=device)
        self.kept = {}

    def _request(self, i: int):
        return self.step(self.params, {"tokens": self.prompts[i % len(self.prompts)]})

    def warm(self) -> None:
        self._request(0)
        sync(self.device)

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        i = 0
        while True:
            logits = self._request(i)
            if i in self.keep:
                self.kept[i] = logits[:, self.positions].float()
            del logits
            sync(self.device)
            i += 1
            # the window also lasts until the requests the check reads are in
            if time.perf_counter() - t0 >= seconds and i > self.keep[-1]:
                break
        window_s = time.perf_counter() - t0
        b, s = self.t["batch"], self.t["tokens"]
        return {"requests": i, "tokens": i * b * s, "window_s": window_s,
                "processed": i * b * s, "pairs": i * b * s * (s + 1) // 2}

    def free(self) -> None:
        """Nothing of the program's is left: each request's logits go with it."""

    def answer(self, logits):
        """The form the check reads of logits (B, P, V) at the checked
        positions: the logits themselves."""
        return logits

    def cases(self):
        """(tokens (B, S), positions (B, P), the port's logits there (B, P, V))
        of each request the check reads."""
        for i in self.keep:
            toks = self.prompts[i % len(self.prompts)]
            at = self.positions[None].expand(toks.shape[0], -1)
            yield toks, at, self.kept[i]


class DecodeLoop:
    def __init__(self, cfg, params, traffic, seed, device, steps, transformer):
        self.params, self.t, self.device = params, traffic, device
        self.step = steps.make_serve_step(cfg)
        gen = torch.Generator(device=device).manual_seed(seed)
        b, p = traffic["sessions"], traffic["prompt_tokens"]
        self.prompts = torch.randint(0, cfg.vocab, (traffic["prompt_pool"], b, p),
                                     generator=gen, device=device)
        # the sessions the check reads, one from each of k equal strata of
        # the batch so that no half of it goes unread, and the columns of
        # their logits kept at every step
        rng = np.random.default_rng(seed)
        k, c = traffic["check"]["sessions"], min(traffic["check"]["columns"], cfg.vocab)
        self.rows = torch.as_tensor([s * b // k + int(rng.integers(b // k)) for s in range(k)],
                                    device=device)
        self.cols = torch.as_tensor(np.sort(rng.choice(cfg.vocab, c, replace=False)),
                                    device=device)
        self.taken = self.rows[:, None] * cfg.vocab + self.cols[None]
        dtype = getattr(torch, traffic["cache_dtype"])
        self.cache = transformer.init_cache(cfg, b, traffic["max_len"], dtype=dtype, device=device)
        self.batches = []        # each: prompts, served tokens, the kept rows
        self.marks = StepMarks(device)
        self.processed = self.pairs = 0     # tokens and kept pairs of every step

    def _step(self, tokens):
        logits, self.cache = self.step(self.params, self.cache, tokens, self.pos)
        self.pos += 1
        self.processed += tokens.shape[0]
        self.pairs += tokens.shape[0] * self.pos
        return logits

    def _start_batch(self):
        """Zeroed cache, the next prompts teacher-forced; the first served
        token and its logit from the last prompt step."""
        for t in (t for group in self.cache.values() for layer in group.values()
                  for t in layer.values()):
            t.zero_()
        prompts = self.prompts[len(self.batches) % len(self.prompts)]
        span = self.t["max_len"] - self.t["prompt_tokens"] + 1
        # the batch before last is whole, as the last one is: its kept rows
        # make room for this batch's
        rows = self.batches[-2].pop("rows") if len(self.batches) >= 2 else torch.empty(
            (len(self.rows), span, len(self.cols)), dtype=torch.float32, device=self.device)
        rec = {"prompts": prompts, "n": 1, "marks": [], "rows": rows,
               "tok": torch.empty((prompts.shape[0], span), dtype=torch.int64, device=self.device)}
        self.pos = 0
        for i in range(prompts.shape[1]):
            logits = self._step(prompts[:, i:i + 1])
        self._take(rec, logits, 0)
        self.batches.append(rec)
        return rec

    def _take(self, rec, logits, n):
        last = logits[:, -1]
        tok = torch.argmax(last, dim=-1, keepdim=True)
        rec["tok"][:, n:n + 1].copy_(tok)
        rec["rows"][:, n].copy_(torch.take(last, self.taken))
        rec["cur"] = tok

    def warm(self) -> None:
        self._start_batch()
        sync(self.device)

    def window(self, seconds: float) -> dict:
        rec = self.batches[-1]
        steps = 0
        processed, pairs = self.processed, self.pairs
        t0 = time.perf_counter()
        while True:
            if self.pos == self.t["max_len"]:
                rec = self._start_batch()
            logits = self._step(rec["cur"])
            self._take(rec, logits, rec["n"])
            rec["n"] += 1
            rec["marks"].append(len(self.marks.marks))
            self.marks.mark()
            steps += 1
            # the window also lasts until two steps give a time between tokens
            if time.perf_counter() - t0 >= seconds and steps >= 2:
                break
        sync(self.device)
        window_s = time.perf_counter() - t0
        tbt = [self.marks.ms(m0, m1) for r in self.batches
               for m0, m1 in zip(r["marks"], r["marks"][1:])]
        b = self.t["sessions"]
        return {"steps": steps, "tokens": steps * b, "window_s": window_s,
                "processed": self.processed - processed, "pairs": self.pairs - pairs,
                "tbt_ms": tbt, "batches": len(self.batches)}

    def free(self) -> None:
        del self.cache

    def answer(self, logits):
        """The form the check reads of logits (k, n, V) at the checked
        sessions' positions: the tokens put first and the kept columns."""
        return torch.argmax(logits, dim=-1), logits[..., self.cols]

    def cases(self):
        """The checked sessions of the batch that served the most tokens:
        (prompt and served tokens but the last (k, S), the positions whose
        logits chose each served token (k, n), and the port's answer there:
        those tokens (k, n) and their rows' kept columns (k, n, C))."""
        rec = max((r for r in self.batches if "rows" in r), key=lambda r: r["n"])
        n, p = rec["n"], rec["prompts"].shape[1]
        served = rec["tok"][self.rows, :n]
        toks = torch.cat([rec["prompts"][self.rows], served[:, :-1]], dim=1)
        at = torch.arange(p - 1, p + n - 1, device=self.device)[None].expand(len(self.rows), -1)
        yield toks, at, (served, rec["rows"][:, :n])


def make(traffic, cfg, params, seed, device, steps, transformer):
    if traffic["loop"] != "closed" or traffic.get("clients", 1) != 1:
        raise ValueError(f"only a closed loop of one client runs; the mix asks for "
                         f"{traffic['loop']!r} with {traffic.get('clients', 1)} clients")
    if traffic["kind"] == "prefill":
        return PrefillLoop(cfg, params, traffic, seed, device, steps)
    if traffic["kind"] == "decode":
        return DecodeLoop(cfg, params, traffic, seed, device, steps, transformer)
    raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
