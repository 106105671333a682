"""String-keyed policy registry.

The port's copy of ``repro.core.sched.registry``.

Every entry point — the simulator's callers, ``benchmarks/run.py``,
``examples/*.py``, ``comm_schedule`` — resolves policies through this
registry, so adding a policy is one ``@register("name")`` away from being
benchmarkable everywhere:

    from repro_torch.core.sched import Scheduler, register

    @register("my-policy")
    class MyScheduler(Scheduler):
        def schedule(self, view): ...

    make_scheduler("my-policy", **kwargs)
"""

from __future__ import annotations

from repro_torch.core.sched.base import Scheduler

_REGISTRY: dict[str, type[Scheduler]] = {}


def register(name: str):
    """Class decorator: expose a ``Scheduler`` subclass under ``name``."""

    def deco(cls: type[Scheduler]) -> type[Scheduler]:
        if not (isinstance(cls, type) and issubclass(cls, Scheduler)):
            raise TypeError(f"@register({name!r}) needs a Scheduler subclass")
        if name in _REGISTRY and _REGISTRY[name] is not cls:
            raise ValueError(f"policy name {name!r} already registered "
                             f"to {_REGISTRY[name].__name__}")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def make_scheduler(name: str, **kwargs) -> Scheduler:
    """Instantiate a registered policy by name (kwargs go to __init__)."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scheduling policy {name!r}; available: "
            f"{', '.join(available_policies())}") from None
    return cls(**kwargs)


def available_policies() -> tuple[str, ...]:
    """Sorted names of every registered policy."""
    return tuple(sorted(_REGISTRY))
