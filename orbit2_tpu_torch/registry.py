"""Generic name -> class registries.

The reference keeps three separate copy-pasted registry modules
(models/hub/utils.py:1-9, metrics/utils.py:22-31, transforms/registry.py:1-9).
Here a single factory builds all of them.
"""

from typing import Callable, Dict, TypeVar

T = TypeVar("T")


def make_registry() -> tuple[Dict[str, type], Callable[[str], Callable[[T], T]]]:
    registry: Dict[str, type] = {}

    def register(name: str):
        def decorator(cls):
            registry[name] = cls
            cls.name = name
            return cls

        return decorator

    return registry, register


MODEL_REGISTRY, register_model = make_registry()
METRICS_REGISTRY, register_metric = make_registry()
TRANSFORMS_REGISTRY, register_transform = make_registry()
