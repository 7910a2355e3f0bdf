"""sklearn API glue: ``sklearn.base.BaseEstimator`` when sklearn is
importable (get_params / set_params / clone / grid search), else a minimal
stand-in with the same contract."""

from __future__ import annotations

import inspect

try:
    from sklearn.base import BaseEstimator

except ImportError:  # pragma: no cover - sklearn is an optional dependency

    class BaseEstimator:  # type: ignore[no-redef]
        """Minimal stand-in honoring the sklearn estimator contract."""

        @classmethod
        def _get_param_names(cls):
            sig = inspect.signature(cls.__init__)
            return sorted(
                p.name for p in sig.parameters.values()
                if p.name != "self" and p.kind != p.VAR_KEYWORD
            )

        def get_params(self, deep=True):
            return {n: getattr(self, n) for n in self._get_param_names()}

        def set_params(self, **params):
            valid = set(self._get_param_names())
            for key, val in params.items():
                if key not in valid:
                    raise ValueError(f"invalid parameter {key!r}")
                setattr(self, key, val)
            return self


def resolve_alias(primary, alias, default, primary_name, alias_name):
    """Resolve a reference-name kwarg alias pair (``reg``/``lambda_``,
    ``n_sweeps``/``max_iter``). ``primary`` defaults to None so an explicit
    value equal to the documented default is still distinguishable; both
    set to different values raises."""
    if alias is None:
        return default if primary is None else primary
    if primary is not None and primary != alias:
        raise ValueError(
            f"both {primary_name}={primary} and its alias "
            f"{alias_name}={alias} are set; pass only one")
    return alias


def not_ported(what: str, item: str, estimator: str) -> NotImplementedError:
    """The error of a path the port does not have yet, naming its ROADMAP
    item and the JAX package's estimator that has it."""
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP.md, {item}); use "
        f"recommendation_models_tpu.{estimator} for it")


__all__ = ["BaseEstimator", "not_ported", "resolve_alias"]
