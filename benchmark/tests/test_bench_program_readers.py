"""The readers of the program's own spans and counters
(multipathnet_tpu_torch.utils.profiling): fed fake records and a fake
layer, each returns its mean over the roots, and None where the roots
found are not one a batch or step, where a span lacks its device interval,
or where the layer is another kind's."""

from __future__ import annotations

import pytest

from benchmark import harness

SERVE = {"kind": "serve", "batches": 2,
         "span_device_s": {"detect.put": 0.0015, "features": 0.008}}
TRAIN = {"kind": "train", "steps": 2}


def span(name, device_ms=None, children=()):
    return {"name": name, "device_ms": device_ms, "children": list(children)}


def root(name, counters, children=(), device_ms=None):
    return dict(span(name, device_ms, children), counters=counters)


DETECT = [root("detect", {"sync.put": 4, "sync.fetch": 5,
                          "sync.nms_round": 3, "nms.rounds": 3,
                          "h2d.bytes": 100}),
          root("detect", {"sync.put": 4, "sync.fetch": 5,
                          "sync.nms_round": 5, "nms.rounds": 5})]
STEPS = [root("train.step", {"sync.put": 7, "sync.check_windows": 4},
              [span("train.backward", 20.0,
                    [span("pool_rois.backward", 1.5),
                     span("pool_rois.backward", 0.5)]),
               span("train.optimizer", 8.0)]),
         root("train.step", {"sync.put": 7, "sync.check_windows": 2},
              [span("train.backward", 20.0,
                    [span("pool_rois.backward", 1.0)]),
               span("train.optimizer", 6.0)])]


@pytest.fixture
def fake_records(monkeypatch):
    from multipathnet_tpu_torch.utils import profiling

    def use(records):
        monkeypatch.setattr(profiling, "records", lambda: records)
    return use


@pytest.mark.parametrize("name,layer,records,want", [
    ("host_syncs.serve", SERVE, DETECT, 13.0),
    ("nms_rounds.serve", SERVE, DETECT, 4.0),
    ("host_syncs.train", TRAIN, STEPS, 10.0),
    ("optimizer_ms.train", TRAIN, STEPS, 7.0),
    ("pool_backward_ms.train", TRAIN, STEPS, 1.5),
])
def test_reader_means_over_roots(fake_records, name, layer, records, want):
    read = harness.load_reader(name)
    fake_records(records)
    assert read(layer) == pytest.approx(want)
    # a root too few or too many: the slice is not the one measured
    fake_records(records[:1])
    assert read(layer) is None
    fake_records(records + records[:1])
    assert read(layer) is None
    fake_records([])
    assert read(layer) is None
    other = TRAIN if layer is SERVE else SERVE
    fake_records(records)
    assert read(other) is None and read(None) is None


@pytest.mark.parametrize("name", ["optimizer_ms.train",
                                  "pool_backward_ms.train"])
def test_span_reader_needs_device_intervals(fake_records, name):
    """Off the card a span has no device interval, and a step without the
    span reads nothing either."""
    read = harness.load_reader(name)
    no_device = [root("train.step", {}, [
        span("train.backward", None, [span("pool_rois.backward")]),
        span("train.optimizer")])] * 2
    fake_records(no_device)
    assert read(TRAIN) is None
    fake_records([root("train.step", {})] * 2)
    assert read(TRAIN) is None


def test_roots_of_other_names_are_not_counted(fake_records):
    read = harness.load_reader("host_syncs.serve")
    fake_records(DETECT + [root("train.step", {"sync.put": 99})])
    assert read(SERVE) == pytest.approx(13.0)


def test_h2d_reads_the_put_span():
    read = harness.load_reader("h2d_ms.serve")
    assert read(SERVE) == pytest.approx(1.5)
    assert read(dict(SERVE, span_device_s={"features": 0.008})) is None
    assert read(TRAIN) is None and read(None) is None


@pytest.mark.parametrize("name", ["host_syncs.serve", "nms_rounds.serve",
                                  "host_syncs.train", "optimizer_ms.train",
                                  "pool_backward_ms.train"])
def test_reader_of_a_program_without_records(monkeypatch, name):
    """A program with no records() (the parent of the change that added
    them) reads nothing, without raising."""
    from multipathnet_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "records")
    layer = SERVE if name.endswith(".serve") else TRAIN
    assert harness.load_reader(name)(layer) is None
