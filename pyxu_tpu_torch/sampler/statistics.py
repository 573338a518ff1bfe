"""Online statistics over a stream of samples (counterpart of
``pyxu_tpu/sampler/statistics.py``).

``update(x)`` folds one sample in and returns the current value;
``stat()`` returns it.  The state stays on the sample's device, in the
sample's dtype, and ``update`` reads nothing back to the host, so a chain
on the card and its statistics run without a wait.  Statistics compose
with ``+ - * / **``.  The JAX package refuses ``update`` under a trace,
where its Python counters would freeze; eager torch has no trace, so that
guard has no counterpart here.
"""

from __future__ import annotations

import operator

import torch

__all__ = [
    "OnlineStat",
    "OnlineMoment",
    "OnlineCenteredMoment",
    "OnlineVariance",
    "OnlineStd",
    "OnlineSkewness",
    "OnlineKurtosis",
]


class OnlineStat:
    """A streaming statistic."""

    def update(self, x):
        raise NotImplementedError

    def stat(self):
        raise NotImplementedError

    def __add__(self, other):
        return _BinStat(self, other, operator.add)

    def __sub__(self, other):
        return _BinStat(self, other, operator.sub)

    def __mul__(self, other):
        return _BinStat(self, other, operator.mul)

    def __truediv__(self, other):
        return _BinStat(self, other, operator.truediv)

    def __pow__(self, k):
        return _PowStat(self, k)


def _value(s, method, x=None):
    if not isinstance(s, OnlineStat):
        return s
    return s.stat() if method == "stat" else s.update(x)


class _BinStat(OnlineStat):
    def __init__(self, lhs, rhs, fn):
        self._l, self._r, self._fn = lhs, rhs, fn

    def update(self, x):
        return self._fn(_value(self._l, "update", x),
                        _value(self._r, "update", x))

    def stat(self):
        return self._fn(_value(self._l, "stat"), _value(self._r, "stat"))


class _PowStat(OnlineStat):
    def __init__(self, base, k):
        self._b, self._k = base, k

    def update(self, x):
        return self._b.update(x) ** self._k

    def stat(self):
        return self._b.stat() ** self._k


class OnlineMoment(OnlineStat):
    """E[x^k]."""

    def __init__(self, order: int = 1):
        self._k = int(order)
        self._n = 0
        self._acc = None

    def update(self, x):
        v = torch.as_tensor(x) ** self._k
        self._acc = v if self._acc is None else self._acc + v
        self._n += 1
        return self._acc / self._n

    def stat(self):
        if self._acc is None:
            raise RuntimeError("OnlineMoment.stat() before any update()")
        return self._acc / self._n


class OnlineCenteredMoment(OnlineStat):
    """E[(x - mean)^k], k in {2, 3, 4}, by the exact single-pass Pebay
    recurrences."""

    def __init__(self, order: int = 2):
        assert 2 <= order <= 4
        self._k = int(order)
        self._n = 0
        self._mean = None
        self._M2 = self._M3 = self._M4 = None

    def update(self, x):
        x = torch.as_tensor(x)
        if self._mean is None:
            z = torch.zeros_like(x)
            self._mean, self._M2, self._M3, self._M4 = z, z, z, z
        n1 = self._n
        self._n = n = n1 + 1
        delta = x - self._mean
        d_n = delta / n
        d_n2 = d_n * d_n
        term1 = delta * d_n * n1
        self._mean = self._mean + d_n
        if self._k >= 4:
            self._M4 = (self._M4 + term1 * d_n2 * (n * n - 3 * n + 3)
                        + 6 * d_n2 * self._M2 - 4 * d_n * self._M3)
        if self._k >= 3:
            self._M3 = self._M3 + term1 * d_n * (n - 2) - 3 * d_n * self._M2
        self._M2 = self._M2 + term1
        return self.stat()

    def stat(self):
        if self._n == 0:
            raise RuntimeError(
                "OnlineCenteredMoment.stat() before any update()")
        M = {2: self._M2, 3: self._M3, 4: self._M4}[self._k]
        return M / self._n


def OnlineVariance():
    """E[(x - mu)^2]."""
    return OnlineCenteredMoment(2)


def OnlineStd():
    """sqrt(E[(x - mu)^2]) (the population form, divided by n)."""
    return OnlineCenteredMoment(2) ** 0.5


def OnlineSkewness():
    """E[(x - mu)^3] / sigma^3."""
    return OnlineCenteredMoment(3) / (OnlineCenteredMoment(2) ** 1.5)


def OnlineKurtosis():
    """E[(x - mu)^4] / sigma^4."""
    return OnlineCenteredMoment(4) / (OnlineCenteredMoment(2) ** 2)
