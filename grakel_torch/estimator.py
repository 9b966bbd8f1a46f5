"""The few scikit-learn conventions the kernels rely on, without
scikit-learn (the port's target machine does not install it).

* :class:`BaseEstimator` — ``get_params`` / ``set_params`` read and
  write the constructor's named parameters, nested ones as
  ``outer__inner``, like ``sklearn.base.BaseEstimator``;
* :class:`NotFittedError` — subclasses ``ValueError`` and
  ``AttributeError``, as ``sklearn.exceptions.NotFittedError`` does;
* :func:`check_random_state` — ``None`` / int / ``RandomState`` to a
  ``np.random.RandomState``, as ``sklearn.utils.check_random_state``.
"""

from __future__ import annotations

import inspect
import numbers

import numpy as np

__all__ = ["BaseEstimator", "NotFittedError", "check_random_state"]


class NotFittedError(ValueError, AttributeError):
    """Raised when a kernel is used before ``fit``."""


def check_random_state(seed):
    """Turn ``seed`` into a ``np.random.RandomState`` instance."""
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, numbers.Integral):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError("%r cannot be used to seed a numpy.random.RandomState "
                     "instance" % (seed,))


class BaseEstimator:
    """Constructor-parameter introspection (get_params / set_params)."""

    @classmethod
    def _get_param_names(cls):
        init = cls.__init__
        if init is object.__init__:
            return []
        params = inspect.signature(init).parameters.values()
        for p in params:
            if p.kind == p.VAR_POSITIONAL:
                raise RuntimeError("estimators may not take *args in "
                                   "__init__ (%s)" % cls.__name__)
        return sorted(p.name for p in params
                      if p.name != "self" and p.kind != p.VAR_KEYWORD)

    def get_params(self, deep=True):
        out = {}
        for key in self._get_param_names():
            value = getattr(self, key)
            if deep and hasattr(value, "get_params") \
                    and not isinstance(value, type):
                out.update((key + "__" + k, v)
                           for k, v in value.get_params().items())
            out[key] = value
        return out

    def set_params(self, **params):
        if not params:
            return self
        valid = self.get_params(deep=True)
        nested = {}
        for key, value in params.items():
            key, delim, sub = key.partition("__")
            if key not in valid:
                raise ValueError("Invalid parameter %r for estimator %s. "
                                 "Valid parameters are: %r."
                                 % (key, type(self).__name__,
                                    sorted(self._get_param_names())))
            if delim:
                nested.setdefault(key, {})[sub] = value
            else:
                setattr(self, key, value)
                valid[key] = value
        for key, sub in nested.items():
            valid[key].set_params(**sub)
        return self

    def __repr__(self):
        args = ", ".join("%s=%r" % kv
                         for kv in self.get_params(deep=False).items())
        return "%s(%s)" % (type(self).__name__, args)
