"""A number the driver measured across the window on the host's clock
(``key`` of its ``metrics``), read as it stands: in a traced run the
profiler records the host's operations, which slows the host loops. None
where the driver measured no such number."""

from __future__ import annotations


def read(ctx: dict, key: str):
    return ctx["measured"].get(key)
