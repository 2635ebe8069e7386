"""How closely a kernel must agree with its plain version.

A kernel and its plain version take float32 sums in different orders.
In float32 that moves the last bits only.  In a 16-bit working dtype a
sum that lies next to a rounding boundary can round to the neighbouring
value on one side and not on the other: a step of one ulp of that
intermediate, which then passes into the result in full, whatever the
result's own magnitude.  So a 16-bit comparison holds every element to
``tol`` (absolute and relative) except for a small share of such steps,
each at most ``step``: one ulp of the working dtype at magnitude 2..4,
the largest intermediates of the scorer's kernels.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Tolerance:
    tol: float         # absolute and relative bound on every other element
    step: float        # the largest rounding step allowed
    step_share: float  # the largest share of elements that may step


TOLERANCES = {
    torch.float32: Tolerance(1e-4, 0.0, 0.0),
    torch.bfloat16: Tolerance(2e-3, 2.0 ** -6, 1e-3),
    torch.float16: Tolerance(1e-3, 2.0 ** -9, 1e-3),
}


def compare(got: torch.Tensor, want: torch.Tensor, tolerance: Tolerance) -> dict:
    """``got`` against ``want`` (same shape) → ``{"ok", "max_abs_err",
    "steps"}``: whether every element is within ``tolerance``, the largest
    absolute difference, and how many elements needed a rounding step."""
    if got.shape != want.shape:
        raise ValueError(f"shapes differ: {tuple(got.shape)} vs {tuple(want.shape)}")
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    finite = bool(torch.isfinite(got).all() and torch.isfinite(want).all())
    beyond = diff > tolerance.tol + tolerance.tol * want.abs()
    steps = int(beyond.sum())
    ok = (finite and steps <= tolerance.step_share * diff.numel()
          and bool((diff[beyond] <= tolerance.step).all()))
    return {"ok": ok, "max_abs_err": float(diff.max()) if diff.numel() else 0.0,
            "steps": steps}
