"""The port's flight recorder (``repro_torch.obs``) against the
reference's (``repro.obs``): the same sequence of ``record`` calls gives
equal event tables (masked records are bit-for-bit no-ops, the cursor
is monotonic, overwritten events are reported as dropped), and the
metrics registry behaves the same (propagation, histograms,
``counter_property``, ``sync_budget``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro_torch import obs

CPU = "cpu"


def _sequence(n=11):
    """(kind, t, slot, payload, mask) rows, some masked, some short."""
    rng = np.random.default_rng(5)
    rows = []
    for i in range(n):
        width = int(rng.integers(1, obs.PAYLOAD_WIDTH + 1))
        rows.append((int(rng.integers(0, 3)), 100 + i, int(rng.integers(-1, 9)),
                     [float(x) for x in rng.standard_normal(width)],
                     bool(i % 4 != 2)))
    return rows


def _record_both(capacity, rows, *, tensors):
    ring = obs.ring_init(capacity, device=CPU)
    jring = jobs.ring_init(capacity)
    for kind, t, slot, pay, mask in rows:
        if tensors:       # device-tensor arguments, as the engine passes
            args = (torch.tensor(kind), torch.tensor(t, dtype=torch.int32),
                    torch.tensor([slot]), torch.tensor(pay),
                    torch.tensor(mask))
        else:
            args = (kind, t, slot, pay, mask)
        ring = obs.record(ring, *args[:4], mask=args[4])
        jring = jobs.record(jring, kind, t, slot, pay, mask=mask)
    return ring, jring


def _assert_rings_equal(ring, jring):
    for got, want in zip(ring, jring):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ev, jev = obs.flush(ring), jobs.flush(jring)
    for f in ("kind", "t", "slot", "payload"):
        np.testing.assert_array_equal(getattr(ev, f), getattr(jev, f))
    assert ev.dropped == jev.dropped


@pytest.mark.parametrize("capacity", [16, 8, 3])
@pytest.mark.parametrize("tensors", [False, True])
def test_ring_matches_reference(capacity, tensors):
    rows = _sequence()
    ring, jring = _record_both(capacity, rows, tensors=tensors)
    _assert_rings_equal(ring, jring)
    recorded = sum(r[4] for r in rows)
    assert int(ring.cursor) == recorded
    assert obs.flush(ring).dropped == recorded - min(recorded, capacity)


def test_masked_record_is_a_bitwise_noop():
    ring, _ = _record_both(4, _sequence(6), tensors=False)
    same = obs.record(ring, obs.EV_SERVE, 7, 3, [1.5, float("nan")],
                      mask=torch.tensor(False))
    for a, b in zip(ring, same):
        assert torch.equal(a, b)


def test_recorder_ingest_merge_save_load(tmp_path):
    rows = _sequence(9)
    rec, jrec = obs.FlightRecorder(), jobs.FlightRecorder()
    for off in (0, 40):
        ring, jring = _record_both(5, rows, tensors=True)
        assert rec.ingest(ring, t_offset=off) == jrec.ingest(jring,
                                                             t_offset=off)
    ev, jev = rec.events(), jrec.events()
    for k in ev:
        np.testing.assert_array_equal(ev[k], jev[k])
    assert rec.dropped == jrec.dropped > 0 and len(rec) == len(jrec)
    path = str(tmp_path / "events.npz")
    rec.save(path)
    back = obs.FlightRecorder.load(path)
    assert back.dropped == rec.dropped
    for k, v in back.events().items():
        np.testing.assert_array_equal(v, ev[k])
    merged = obs.merge_events(ev, obs.FlightRecorder().events())
    jmerged = jobs.merge_events(jev, jobs.FlightRecorder().events())
    for k in merged:
        np.testing.assert_array_equal(merged[k], jmerged[k])
    np.testing.assert_array_equal(
        obs.payload_column(ev, obs.EV_PASS, "battery_j"),
        jobs.payload_column(jev, jobs.EV_PASS, "battery_j"))


def test_plane_batched_ring_ingests_per_plane():
    ring = obs.ring_init(4, batch=(2,), device=CPU)
    jring = jobs.ring_init(4, batch=(2,))
    rec, jrec = obs.FlightRecorder(), jobs.FlightRecorder()
    assert rec.ingest(ring) == jrec.ingest(jring) == 0
    with pytest.raises(ValueError, match="flat"):
        obs.record(ring, obs.EV_PASS, 0, 0, [1.0])
    assert tuple(ring.kind.shape) == tuple(jnp.shape(jring.kind)) == (2, 4)


def test_registry_propagation_histograms_and_sync_budget():
    for mod in (obs, jobs):
        parent = mod.MetricsRegistry()
        child = mod.MetricsRegistry("sim", parent=parent)
        child.inc("host_syncs", 2)
        child.counter("host_syncs").set(5)
        for x in (0.5, 1.5, 4.0):
            child.histogram("dispatch_s").record(x)
        assert parent.counter("sim.host_syncs").value == 5
        with mod.sync_budget(2, registry=parent):
            child.inc("host_syncs", 2)
        with pytest.raises(mod.SyncBudgetExceeded, match="3 host syncs"):
            with mod.sync_budget(2, registry=parent):
                child.inc("host_syncs", 3)
    got = obs.MetricsRegistry("x")
    want = jobs.MetricsRegistry("x")
    for reg in (got, want):
        for x in (0.5, 1.5, 4.0):
            reg.histogram("h").record(x)
        reg.gauge("g").set(3)
    assert got.to_dict() == want.to_dict()


def test_counter_property():
    class Engine:
        traces = obs.counter_property("traces")

        def __init__(self):
            self.metrics = obs.MetricsRegistry("e", parent=obs.reset_global())

    eng = Engine()
    eng.traces += 1
    eng.traces += 1
    assert eng.traces == 2 == eng.metrics.counter("traces").value
    assert obs.global_registry().counter("e.traces").value == 2
    eng.traces = 0
    assert obs.global_registry().counter("e.traces").value == 0
