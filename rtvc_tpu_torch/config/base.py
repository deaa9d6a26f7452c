"""Typed hyper-parameter containers.

The reference scatters parameters over five ``HParams`` attr-dict modules with a
comma-string override parser (ref: config/hparams.py:7-29). Here every config is
a frozen ``dataclasses.dataclass`` so that configs are hashable and typo-proof,
while keeping the same ``parse("k=v,...")`` override capability on top of
``dataclasses.replace``.

This package's own copy of ``rtvc_tpu/config/base.py``: the port imports nothing
of the JAX package.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Any, TypeVar

T = TypeVar("T", bound="Config")


@dataclasses.dataclass(frozen=True)
class Config:
    """Base class for all hyper-parameter groups."""

    def replace(self: T, **kwargs: Any) -> T:
        return dataclasses.replace(self, **kwargs)

    def parse(self: T, string: str) -> T:
        """Override fields from a ``"name=value,name=value"`` string.

        Values are parsed with ``ast.literal_eval`` (same contract as the
        reference's ``HParams.parse``, ref: config/hparams.py:20-29).
        """
        if not string:
            return self
        overrides: dict[str, Any] = {}
        for item in string.split(","):
            key, _, value = item.partition("=")
            key = key.strip()
            if not hasattr(self, key):
                raise KeyError(f"{type(self).__name__} has no field {key!r}")
            overrides[key] = ast.literal_eval(value.strip())
        return self.replace(**overrides)

    def asdict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)
