"""The ``spans`` reader on a store of the program's spans filled by hand,
and the metric files that name it."""

import inspect
import re
import sys
import types
from pathlib import Path

import pytest

from portbench.harness.core import all_of
from portbench.readers import spans as reader
from sspv_tpu_torch.utils import profiling

CHECKOUT = Path(__file__).resolve().parents[2]
MS = 1_000_000  # ns


@pytest.fixture
def store(monkeypatch):
    """Two dispatches, one publish, three polls on one thread, and a take
    holding a dispatch; times in ms."""
    def rec(i, name, t0, t1, parent=None):
        return (i, name, 1, t0 * MS, t1 * MS, parent, i)

    records = [
        rec(0, "sspv.engine.dispatch", 10, 12, parent=5),
        rec(1, "sspv.engine.poll_wait", 12, 13),
        rec(2, "sspv.engine.poll_wait", 13, 14),
        rec(3, "sspv.engine.publish", 14, 18),
        rec(4, "sspv.engine.poll_wait", 18, 19),
        rec(5, "sspv.engine.take", 9, 20),
        rec(6, "sspv.engine.dispatch", 20, 23),
    ]
    monkeypatch.setattr(profiling, "_records", records)
    monkeypatch.setattr(profiling, "_dropped", 0)
    return records


def test_sums_and_counts(store):
    ctx = {}
    # (take 11 + dispatches 2 + 3 + publish 4) ms over 2 dispatches, in us
    assert reader.read(ctx, ["sspv.engine.take", "sspv.engine.dispatch",
                             "sspv.engine.publish"],
                       ["sspv.engine.dispatch"], "duration", 1e6) == \
        pytest.approx(10_000.0)
    assert reader.read(ctx, ["sspv.engine.poll_wait"],
                       ["sspv.engine.dispatch"], "count") == 1.5
    # a name with no span adds nothing; the take's self time is its own
    assert reader.read(ctx, ["sspv.engine.publish", "sspv.no.such"],
                       ["sspv.engine.publish"], "duration", 1e3) == \
        pytest.approx(4.0)
    assert profiling.span_totals()["sspv.engine.take"]["self_seconds"] == \
        pytest.approx(0.009)


def test_none_without_a_den_span(store):
    assert reader.read({}, ["sspv.engine.publish"], ["sspv.k4.vad"]) is None
    profiling.clear_spans()
    assert reader.read({}, ["sspv.k4.vad"], ["sspv.k4.vad"]) is None


def test_none_where_the_program_keeps_no_spans(monkeypatch):
    """An earlier program's ``profiling`` module, without spans."""
    monkeypatch.setitem(sys.modules, "sspv_tpu_torch.utils.profiling",
                        types.ModuleType("sspv_tpu_torch.utils.profiling"))
    assert reader.totals() is None
    assert reader.read({}, ["sspv.k4.vad"], ["sspv.k4.vad"]) is None


def test_the_metric_files_name_what_exists():
    """Each metric read from spans names arguments the reader takes, and
    spans the program opens."""
    params = set(inspect.signature(reader.read).parameters) - {"ctx"}
    opened = set()
    for path in (CHECKOUT / "sspv_tpu_torch").rglob("*.py"):
        opened |= set(re.findall(r'\bspan\(\s*"([^"]*)"', path.read_text()))
    metrics = [m for m in all_of("metrics") if m["reader"] == "spans"]
    assert {m["name"] for m in metrics} == {
        "program.host_ms_per_call", "vad.wrapper_host_us",
        "engine.host_us_per_dispatch", "engine.polls_per_dispatch"}
    for m in metrics:
        args = m["args"]
        assert set(args) <= params and {"num", "den"} <= set(args), m["name"]
        assert args.get("of", "duration") in ("duration", "count")
        assert set(args["num"]) | set(args["den"]) <= opened, m["name"]
        assert m["source"] == "program_counter"
