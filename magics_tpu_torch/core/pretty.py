"""Pretty-printing of vectors, matrices, and information-form Gaussians for
debugging (counterpart of magics_tpu's core/pretty.py) — the capability of
the reference's `gbp_linalg::pretty_print` (crates/gbp_linalg/src/
pretty_print.rs: box-drawn matrices, per-cell width from the integral digit
count, colored sign/zero/non-finite highlighting).

Takes numpy arrays, lists or torch tensors (on any device: a tensor is
copied to the host once). ANSI color is optional (auto-disabled when stdout
is not a tty); the box drawing uses the same rounded corners as the
reference.
"""

from __future__ import annotations

import math
import os
import sys
from typing import Any

import numpy as np
import torch

_PRECISION = 3
_RESET = "\x1b[0m"
_RED = "\x1b[31m"
_GREEN = "\x1b[32m"
_YELLOW = "\x1b[33m"
_MAGENTA = "\x1b[35m"
_CYAN = "\x1b[36m"

_BAR = "│"
_UL, _UR, _LL, _LR = "╭", "╮", "╰", "╯"


def _host(x: Any) -> np.ndarray:
    """A float64 numpy array of `x` (a torch tensor is copied off its device)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def num_of_integral_digits(f: float) -> int | None:
    """Digits left of the decimal point incl. sign (pretty_print.rs:44-70).

    >>> num_of_integral_digits(0.0)
    1
    >>> num_of_integral_digits(100.0)
    3
    >>> num_of_integral_digits(-1.5)
    2
    >>> num_of_integral_digits(float("nan")) is None
    True
    """
    if math.isnan(f) or math.isinf(f):
        return None
    count = 0
    if math.copysign(1.0, f) < 0:
        f = -f
        count += 1
    if f < 1.0:
        count += 1
    while f >= 1.0:
        f /= 10.0
        count += 1
    return count


def _use_color(color: bool | None) -> bool:
    if color is not None:
        return color
    if os.environ.get("NO_COLOR"):
        return False
    return hasattr(sys.stdout, "isatty") and sys.stdout.isatty()


def _fmt_cell(v: float, width: int, color: bool) -> str:
    if math.isnan(v) or math.isinf(v):
        s = f"{v:>{width}}"
        return f"{_MAGENTA}{s}{_RESET}" if color else s
    s = f"{v:>{width}.{_PRECISION}f}"
    if not color:
        return s
    if v == 0.0:
        return f"{_YELLOW}{s}{_RESET}"
    if v < 0.0:
        return f"{_RED}{s}{_RESET}"
    return f"{_GREEN}{s}{_RESET}"


def format_matrix(
    m: Any, name: str | None = None, color: bool | None = None
) -> str:
    """Box-drawn matrix (or vector as a 1-row matrix), reference style."""
    a = np.atleast_2d(_host(m))
    color = _use_color(color)
    digits = [
        num_of_integral_digits(float(v)) for v in a.ravel()
    ]
    int_w = max((d for d in digits if d is not None), default=1)
    width = int_w + 1 + _PRECISION  # sign+digits, point, fraction
    width = max(width, 3 + len("inf"))

    rows, cols = a.shape
    header = ""
    if name is not None:
        dims = f"{rows}x{cols}" if rows > 1 else f"{cols}"
        label = f"{name} ({dims})"
        header = (f"{_CYAN}{label}{_RESET}" if color else label) + "\n"

    body_width = cols * (width + 1) + 1
    out = [header + _UL + " " * body_width + _UR]
    for i in range(rows):
        cells = " ".join(_fmt_cell(float(a[i, j]), width, color) for j in range(cols))
        out.append(f"{_BAR} {cells} {_BAR}")
    out.append(_LL + " " * body_width + _LR)
    return "\n".join(out)


def format_vector(v: Any, name: str | None = None, color: bool | None = None) -> str:
    return format_matrix(_host(v).reshape(1, -1), name=name, color=color)


def pretty_print_matrix(m: Any, name: str | None = None, color: bool | None = None):
    print(format_matrix(m, name=name, color=color))


def pretty_print_vector(v: Any, name: str | None = None, color: bool | None = None):
    print(format_vector(v, name=name, color=color))


def format_gaussian(
    eta: Any, lam: Any, name: str = "gaussian", color: bool | None = None
) -> str:
    """Information-form Gaussian: eta, Lambda, and (when invertible) the
    recovered mean/covariance — the debugging view of MultivariateNormal."""
    eta = _host(eta)
    lam = _host(lam)
    parts = [
        format_vector(eta, name=f"{name}.eta", color=color),
        format_matrix(lam, name=f"{name}.lam", color=color),
    ]
    try:
        cov = np.linalg.inv(lam)
        mean = cov @ eta
        parts.append(format_vector(mean, name=f"{name}.mean", color=color))
        parts.append(format_matrix(cov, name=f"{name}.cov", color=color))
    except np.linalg.LinAlgError:
        parts.append(f"{name}: precision is singular (no mean/covariance)")
    return "\n".join(parts)
