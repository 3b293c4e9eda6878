"""Factory registry: model and dataset factories by name.

Counterpart of ``ps_slm_tpu/registry.py``.  ``ModelConfig.factory`` and
``DataConfig.factory`` name a registered function; the built-ins are
``"tasu"`` (``models/tasu.py::model_factory``) and ``"multitask"``
(``data/dataset.py::get_speech_dataset``), imported at the first lookup.
"""

from __future__ import annotations

from typing import Callable, Dict

_MODEL_FACTORIES: Dict[str, Callable] = {}
_DATASET_FACTORIES: Dict[str, Callable] = {}


def register_model(name: str):
    def deco(fn: Callable) -> Callable:
        _MODEL_FACTORIES[name] = fn
        return fn
    return deco


def register_dataset(name: str):
    def deco(fn: Callable) -> Callable:
        _DATASET_FACTORIES[name] = fn
        return fn
    return deco


def get_model_factory(name: str) -> Callable:
    _ensure_builtins()
    if name not in _MODEL_FACTORIES:
        raise KeyError(f"unknown model factory {name!r}; known: {sorted(_MODEL_FACTORIES)}")
    return _MODEL_FACTORIES[name]


def get_dataset_factory(name: str) -> Callable:
    _ensure_builtins()
    if name not in _DATASET_FACTORIES:
        raise KeyError(f"unknown dataset factory {name!r}; known: {sorted(_DATASET_FACTORIES)}")
    return _DATASET_FACTORIES[name]


def _ensure_builtins() -> None:
    """Import the built-in factories, which register themselves (lazily,
    to avoid import cycles)."""
    from ps_slm_tpu_torch.data import dataset  # noqa: F401  registers "multitask"
    from ps_slm_tpu_torch.models import tasu  # noqa: F401  registers "tasu"
