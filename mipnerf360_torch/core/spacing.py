"""Disparity (s-space) spacing transforms for unbounded scenes
(counterpart of ``mipnerf360_tpu/core/spacing.py``)."""
from __future__ import annotations

# The reference uses eps=1e-6 inside g() (its parameterization.py:18).
_G_EPS = 1e-6


def g(x):
    """Disparity map g(x) = 1 / (x + eps). Pure (no in-place mutation)."""
    return 1.0 / (x + _G_EPS)


def t_to_s(t_vals, near, far):
    """Map metric distance t to normalized disparity s in [0, 1].

    Mathematically s = (g(t) - g(near)) / (g(far) - g(near)), evaluated in the
    cancellation-free form (a = t+eps, f = far+eps)

        s = ((near - t) * f) / ((near - far) * a)

    whose subtractions are between original magnitudes (Sterbenz-safe).
    """
    a = t_vals + _G_EPS
    f = far + _G_EPS
    return ((near - t_vals) * f) / ((near - far) * a)


def s_to_t(s_vals, near, far):
    """Inverse of :func:`t_to_s`, in the cancellation-free form

        t = (f·n) / (s·n + (1−s)·f) − eps,   n = near+eps, f = far+eps

    which hits the endpoints exactly: s=0 → near, s=1 → far.
    """
    n = near + _G_EPS
    f = far + _G_EPS
    return (f * n) / (s_vals * n + (1.0 - s_vals) * f) - _G_EPS
