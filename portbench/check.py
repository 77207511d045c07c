"""The comparison that decides ``correct``: the window's answers against
the plain reference, in units of the reference's own logits.

At each checked position of each sampled request (prefill) or session
(decode):

* ``err``: the relative error of the logits row, ``|port - ref| / |ref|``
  (vector norms over the row's columns: the whole vocabulary for prefill,
  a sample of columns drawn from the seed before the window for decode).
* ``gap`` (decode): how far the reference's logit of the served token lies
  below the reference's best, in units of the reference row's standard
  deviation over the vocabulary.  A sound program serves the best, or a
  token within its rounding of it.
* ``tie``: the smallest margin, in router logits, between a reference
  router's k-th and (k+1)-th expert over the tokens the position sees.
  Where it is under the traffic's ``near_tie``, a sound program may have
  sent a token to the other expert, and its row and served token may
  differ from the reference's by far more than rounding.  The reference
  alone decides it, so no fault of the program can move it.

The numbers, each the largest over the sampled requests or sessions of a
statistic over its positions before its first near tie (every position
where the mix gives no ``near_tie``, as prefill's do):

* ``logit_err_p50``, ``logit_err_p95``: quantiles of ``err``;
* ``logit_err_share``: the share of positions whose ``err`` is over the
  cell's ``share_over``, where the cell gives one;
* ``logit_err_max`` and, for decode, ``served_gap``: the widest ``err``
  and ``gap``;
* ``left_out`` (decode): the share of positions after a near tie.

Past a near tie a sound program that sent a token to the other expert
carries that token's other hidden state in its Mamba and attention states,
so every later position of the session may differ from the reference by
far more than rounding: no number reads those positions.

A fault on half of a request's positions moves its median; one on a tenth
of them, its 95th percentile or its share over a bound that sound rows
seldom pass; a wrong token served, its gap.  A cell's file names the
numbers compared and their limits; the others are readings only.

The control puts the reference, one precision lower, in the port's place:
its answers are judged as the port's, its served token the one it puts
first.
"""

from __future__ import annotations

import math

import torch

#: the quantiles over a request's or session's positions
QUANTILES = {"logit_err_p50": 0.5, "logit_err_p95": 0.95}

#: the control of each parameter type: the nearest precision below it
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def ties(margins: list[torch.Tensor], at: torch.Tensor) -> torch.Tensor:
    """(B, P): the smallest router margin over the tokens up to each of the
    positions ``at`` (B, P); ``margins`` holds one (B, S) tensor a MoE
    layer of the reference.  Infinite where the model has no router."""
    if not margins:
        return torch.full(at.shape, math.inf, device=at.device)
    low = torch.stack(margins).amin(dim=0).cummin(dim=-1).values
    return low.gather(-1, at)


def units(kind: str, answer, ref: torch.Tensor, tie: torch.Tensor, cols=None) -> list[dict]:
    """Per request or session, the per-position values above.  ``answer``
    is the port's logits (B, P, V) for prefill, (served tokens (k, n), their
    rows at ``cols`` (k, n, C)) for decode; ``ref`` the reference's logits
    at the same positions."""
    if kind == "prefill":
        err = (answer.float() - ref).norm(dim=-1) / ref.norm(dim=-1)
        return [{"err": e, "tie": t} for e, t in zip(err, tie)]
    tok, rows = answer
    want = ref[..., cols]
    err = (rows.float() - want).norm(dim=-1) / want.norm(dim=-1)
    gap = (ref.amax(dim=-1) - ref.gather(-1, tok[..., None])[..., 0]) / ref.std(dim=-1)
    return [{"err": e, "gap": g, "tie": t} for e, g, t in zip(err, gap, tie)]


def numbers(found: list[dict], near_tie=None, share_over=None) -> dict:
    """The numbers of the units ``found``, over the positions whose ``tie``
    is ``near_tie`` or more (every position without ``near_tie``).  A number
    that no unit has such a position for is missing, and fails its limit."""
    errs, gaps, total, left = [], [], 0, 0
    for u in found:
        keep = torch.ones_like(u["err"], dtype=torch.bool) if near_tie is None \
            else u["tie"] >= near_tie
        total, left = total + keep.numel(), left + int((~keep).sum())
        if keep.any():
            errs.append(u["err"][keep].double())
            if "gap" in u:
                gaps.append(float(u["gap"][keep].max()))
    out = {}
    if errs:
        out = {name: max(float(torch.quantile(e, q)) for e in errs)
               for name, q in QUANTILES.items()}
        if share_over is not None:
            out["logit_err_share"] = max(float((e > share_over).double().mean()) for e in errs)
        out["logit_err_max"] = max(float(e.max()) for e in errs)
    if "gap" in found[0]:
        out["left_out"] = left / total
        if gaps:
            out["served_gap"] = max(gaps)
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Every number that has a limit within it (a NaN is not, nor a number
    missing); each of them beside its limit.  The other numbers are shown
    as readings only."""
    shown = {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
    ok = all(k in numbers and numbers[k] <= lim for k, lim in limits.items())
    return ok, shown
