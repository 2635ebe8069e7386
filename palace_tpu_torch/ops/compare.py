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

#: The conv head (K3) at outputs near 40, against its float64 sums.  There
#: float32 sums in any order round up to a few outputs in a thousand to the
#: other neighbour, cuDNN's order too, so up to 3 in a thousand may step,
#: each by at most one ulp at the outputs' magnitude 32..64.  One chain of
#: mma over a whole tile, rounding toward zero at every step, falls outside.
CONV_LARGE_OUTPUTS = {
    torch.float32: TOLERANCES[torch.float32],
    torch.bfloat16: Tolerance(2e-3, 2.0 ** -2, 3e-3),
    torch.float16: Tolerance(1e-3, 2.0 ** -5, 3e-3),
}

#: The SAGE rounds (K2) where their rounded intermediates reach 4..8: round
#: 1's p-node activations and their LayerNorm do so on N(0, 1) inputs (5.8
#: and 6.4 at a batch of 16).  A rounding step there is one ulp at 4..8,
#: twice the default's; the share and the rest of the bound are the default's.
SAGE_LARGE_INTERMEDIATES = {
    torch.float32: TOLERANCES[torch.float32],
    torch.bfloat16: Tolerance(2e-3, 2.0 ** -5, 1e-3),
    torch.float16: Tolerance(1e-3, 2.0 ** -8, 1e-3),
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
