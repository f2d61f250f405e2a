"""Analytic function objects for boundary/initial conditions.

Counterpart of dealii::Function as used by the reference drivers: vectorized
over point arrays, with a time parameter handled by the framework
(set_time/value semantics of flow_base_algorithm.cc).

A scalar function maps (n, dim) -> (n,); a vector function maps
(n, dim) -> (n_components, n). Plain Python callables f(points, time) are
accepted everywhere; these classes only add conveniences.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


class Function:
    """Wrap f(points, time) -> values; n_components=dim for vector fields."""

    def __init__(self, fn: Callable, n_components: int = 1) -> None:
        self.fn = fn
        self.n_components = n_components

    def __call__(self, points: np.ndarray, time: float = 0.0) -> np.ndarray:
        return np.asarray(self.fn(points, time))


class ZeroFunction(Function):
    def __init__(self, n_components: int = 1) -> None:
        self.n_components = n_components

    def __call__(self, points: np.ndarray, time: float = 0.0) -> np.ndarray:
        n = len(points)
        if self.n_components == 1:
            return np.zeros(n)
        return np.zeros((self.n_components, n))


class ConstantFunction(Function):
    def __init__(self, values) -> None:
        values = np.atleast_1d(np.asarray(values, dtype=np.float64))
        self.values = values
        self.n_components = len(values)

    def __call__(self, points: np.ndarray, time: float = 0.0) -> np.ndarray:
        n = len(points)
        if self.n_components == 1:
            return np.full(n, self.values[0])
        return np.broadcast_to(self.values[:, None], (self.n_components, n)).copy()


def as_function(f, n_components: int = 1):
    if f is None:
        return None
    if isinstance(f, Function):
        return f
    return Function(f, n_components)
