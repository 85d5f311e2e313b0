"""Chebyshev coefficients of the sinc blind-rotation indicators.

Port of `fhe_sorting_tpu/utils/sinc_coeffs.py` (the parts DirectSort uses):
high-degree Chebyshev fits of

    sinc_N(x)         = sinc(2N x)                     (the 2N and hybrid placements)
    doubled_sinc_N(x) = sinc(2N x) + sinc(2N x + 1/2)  (the N placement)

on [-1, 1] by a DCT, with negligible terms trimmed, cached per (N, stretch).
"""

from __future__ import annotations

import functools

import numpy as np

FIT_DEGREE = 13011


def _vector_fit(fn, degree: int) -> np.ndarray:
    """Chebyshev-node interpolation with a vectorized fn."""
    n = degree + 1
    theta = (np.arange(n) + 0.5) * np.pi / n
    ys = fn(np.cos(theta))
    ext = np.concatenate([ys, ys[::-1]])
    ph = np.exp(-1j * np.pi * np.arange(2 * n) / (2 * n))
    ck = (np.fft.fft(ext) * ph).real[:n] / n
    ck[0] *= 0.5
    return ck


def _np_scaled_sinc(xs: np.ndarray, N: int) -> np.ndarray:
    t = np.pi * N * xs
    return np.where(np.abs(xs) < 1e-10, 1.0, np.sin(t) / np.where(t == 0, 1, t))


@functools.lru_cache(maxsize=32)
def sinc_coefficients(N: int, degree: int = FIT_DEGREE, tol: float = 1e-6,
                      stretch: float = 1.0) -> tuple:
    """Even scaled-sinc series.  `stretch` > 1 fits f(stretch * y) on y in
    [-1, 1]: the caller divides the argument by `stretch`, so that rank
    noise cannot push the Chebyshev argument outside [-1, 1], where T_k
    explodes."""
    c = _vector_fit(lambda xs: _np_scaled_sinc(stretch * xs, 2 * N), degree)
    c[1::2] = 0.0                      # even function: odd terms are noise
    c[np.abs(c) < tol] = 0.0
    nz = np.nonzero(c)[0]
    return tuple(c[: nz[-1] + 1]) if len(nz) else (0.0,)


@functools.lru_cache(maxsize=32)
def doubled_sinc_coefficients(N: int, degree: int = FIT_DEGREE,
                              tol: float = 1e-8,
                              stretch: float = 1.0) -> tuple:
    """Doubled-sinc series for the argument (index - rank - check) / (2N):
    every integer difference hits an exact sinc zero, peaking only at 0 and
    -N.  `stretch` > 1 fits f(stretch * y) so that rank noise cannot push
    the argument outside [-1, 1]."""
    c = _vector_fit(
        lambda xs: _np_scaled_sinc(stretch * xs, 2 * N)
        + _np_scaled_sinc(stretch * xs + 0.5, 2 * N),
        degree,
    )
    c[np.abs(c) < tol] = 0.0
    nz = np.nonzero(c)[0]
    return tuple(c[: nz[-1] + 1]) if len(nz) else (0.0,)
