"""The reader of graph_tick_share on the synthetic traced run of
test_bench_spans: the share of the ticks' `decode.slow` spans marked
graph=True, against a number worked out by hand."""

import pytest

from benchmark.harness import cell as cells
from benchmark.tests.test_bench_spans import _run, _spans, recorded  # noqa: F401
from fish_speech_tpu_torch.utils import profiling


def test_graph_tick_share(recorded, monkeypatch):  # noqa: F811
    """A prefill's slow span and another thread's are left out; None on a
    program whose spans carry no `graph` attribute (the synthetic run's
    own, as the parent of the graph's commit)."""
    read = cells.reader("graph_tick_share")
    assert read(_run(recorded)) is None
    marks = {2: False, 6: True, 8: True, 13: False, 22: True}
    base = recorded
    spans = [s._replace(attrs={**s.attrs, "graph": marks[s.id]})
             if s.id in marks else s for s in _spans(base)]
    monkeypatch.setattr(profiling, "recorded_spans", lambda: spans)
    got = read(_run(base))
    assert isinstance(got, float)
    assert got == pytest.approx(100 * 2 / 3)
    assert read(_run(base, trace=False)) is None
