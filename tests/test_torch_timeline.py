"""The port's timeline export (``repro_torch.obs.timeline``) against the
reference's ``repro.obs.timeline`` on the same event tables: the Chrome
trace (as JSON text), the text digest and the validator's verdicts are
equal. One table is written by hand through the port's telemetry rings
(passes in and out of eclipse, serving windows, metered and free
exchanges, two planes); the other comes from a small fleet run under
eclipses and an epidemic with the async ISL gossip."""
import json

import numpy as np
import pytest

from _torch_helpers import one_torch_thread
from repro.obs import timeline as jtl
from repro_torch.core.energy import PassBudget
from repro_torch.core.orbits import OrbitalPlane
from repro_torch.core.sl_step import autoencoder_adapter
from repro_torch.fleet import (EclipseConfig, EpidemicConfig, FleetConfig,
                               FleetEngine, ScenarioConfig)
from repro_torch.isl import CodecConfig, ContactConfig, ExchangeConfig
from repro_torch.obs import (EV_EXCHANGE, EV_PASS, EV_SERVE, FlightRecorder,
                             record, ring_init, timeline_summary,
                             to_chrome_trace, validate_chrome_trace,
                             write_chrome_trace)
from repro_torch.sim import DeviceImageryShards


def _hand_table():
    """Two planes' rings: passes (actions 0-4, a NaN loss, eclipse runs
    that open and close), serving windows, a metered and a free
    exchange."""
    rec = FlightRecorder()
    for plane in range(2):
        ring = ring_init(16, device="cpu")
        for t in range(8):
            lit = float((t + plane) % 4 >= 2)
            loss = float("nan") if t % 5 == 3 else 0.5 / (t + 1)
            ring = record(ring, EV_PASS, t, t % 3, [
                t % 5, 150.0 - 7.5 * t, loss, 2.0, 1.0, float(t == 4), lit,
                float(t % 2)])
        ring = record(ring, EV_SERVE, 3, plane, [
            4.0, 120.0, 3.0, 1.0 + plane, 96.0, 0.0, 1.0, 2.0])
        ring = record(ring, EV_SERVE, 6, -1, [2.0, 90.0, 2.0, 0.0, 64.0,
                                              1.0, 0.0, 1.0])
        ring = record(ring, EV_EXCHANGE, 4, plane, [0.0, 7.05e6, 7.05e-4,
                                                    2.0, 0.41666666])
        ring = record(ring, EV_EXCHANGE, 8, -1, (1.0,))
        rec.ingest(ring)
    return rec.events()


def _fleet_table():
    with one_torch_thread():
        fleet = FleetEngine(
            autoencoder_adapter(cut=5, img=32),
            PassBudget(plane=OrbitalPlane(n_sats=4), n_items=4e6),
            DeviceImageryShards(img=32, batch=4, device="cpu"),
            FleetConfig(n_planes=2, n_revolutions=2, max_steps_per_pass=2,
                        seed=0, avg_every=0, battery_j=200.0,
                        recharge_w=0.02, reserve_j=180.0,
                        scenario=ScenarioConfig(
                            eclipse=EclipseConfig(period=4, duty=0.5,
                                                  stagger=1),
                            epidemic=EpidemicConfig(beta=0.6, ttl=2)),
                        exchange=ExchangeConfig(
                            codec=CodecConfig("int8"),
                            contact=ContactConfig(period=2))),
            device="cpu")
        fleet.run(stream_telemetry=True)
    return fleet.recorder.events()


@pytest.mark.parametrize("table", ["hand", "fleet"])
@pytest.mark.parametrize("window_s", [1.0, 227.5])
def test_chrome_trace_and_summary_match_reference(table, window_s,
                                                  tmp_path):
    events = _hand_table() if table == "hand" else _fleet_table()
    kinds = set(events["kind"].tolist())
    assert {EV_PASS, EV_EXCHANGE} <= kinds
    got = to_chrome_trace(events, window_s=window_s)
    want = jtl.to_chrome_trace(events, window_s=window_s)
    assert json.dumps(got) == json.dumps(want)
    validate_chrome_trace(got)
    names = {e["name"] for e in got["traceEvents"]}
    assert "eclipse" in names and "plane exchange" in names
    assert timeline_summary(events) == jtl.timeline_summary(events)
    assert "bits" in timeline_summary(events)
    path = tmp_path / "trace.json"
    written = write_chrome_trace(str(path), events, window_s=window_s)
    assert json.dumps(written) == json.dumps(want)
    with open(path) as fh:
        assert fh.read() == json.dumps(want)


def test_empty_table_matches_reference():
    events = FlightRecorder().events()
    assert json.dumps(to_chrome_trace(events)) == \
        json.dumps(jtl.to_chrome_trace(events))
    assert timeline_summary(events) == jtl.timeline_summary(events)


@pytest.mark.parametrize("bad", [
    [], {"events": []}, {"traceEvents": {}}, {"traceEvents": [1]},
    {"traceEvents": [{"ph": "X", "pid": 0, "tid": 0}]},
    {"traceEvents": [{"ph": "X", "pid": 0, "tid": 0, "name": "a",
                      "ts": 0}]},
    {"traceEvents": [{"ph": "C", "pid": 0, "tid": 0, "name": "a"}]}])
def test_validator_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError) as got:
        validate_chrome_trace(bad)
    with pytest.raises(ValueError) as want:
        jtl.validate_chrome_trace(bad)
    assert str(got.value) == str(want.value)


def test_hand_table_rows_are_what_was_recorded():
    events = _hand_table()
    assert len(events["kind"]) == 2 * (8 + 2 + 2)
    assert np.isnan(events["payload"][(events["kind"] == EV_PASS)
                                      & (events["t"] == 3)][:, 2]).all()
