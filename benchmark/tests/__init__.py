"""CPU tests of the benchmark (cards: ``-m cuda``).

``test_bench_harness.py`` holds for every cell of ``BENCHMARK.json``, of
whatever kind; ``test_kind_<kind>.py`` holds what one kind has of its
own; ``test_new_kind.py`` adds a cell of a new kind to a copy of the
benchmark from new files only."""

from __future__ import annotations

import json
from pathlib import Path

TINY = Path(__file__).resolve().parent / "tiny"


def tiny(config):
    """``tiny/<config>.json``: the configuration's overrides at tiny widths
    (``recipe``, ``traffic``; ``sound``: see :func:`overrides`)."""
    return json.loads((TINY / f"{config}.json").read_text())


def overrides(config, sound=False):
    """The harness's ``config_override`` of a configuration at tiny widths;
    with ``sound``, the tiny file's ``sound`` overrides on top."""
    t = tiny(config)
    over = {k: dict(v) for k, v in t.items() if k != "sound"}
    if sound:
        for k, v in t.get("sound", {}).items():
            over[k] = dict(over.get(k, {}), **v)
    return over
