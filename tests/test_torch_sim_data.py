"""The port's on-device batch provider (``repro_torch.sim.data``): a
batch is a pure function of (seed, sat, idx), equal whether the indices
come as Python ints or as tensors (the host engine's call and the
device loop's), with the reference provider's shapes, dtypes and label
range, non-IID across satellites; and the port's energy state against
the reference's on the same sequence of updates."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sim import data as jdata
from repro.sim import energy_state as jes
from repro_torch.sim import data, energy_state as es

CPU = "cpu"
SHARDS = data.DeviceImageryShards(img=32, batch=4, device=CPU)


def test_batch_is_a_pure_function_of_its_indices():
    a, b = SHARDS(2, 5), SHARDS(2, 5)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(SHARDS(3, 5)["images"], a["images"])
    assert not torch.equal(SHARDS(2, 6)["images"], a["images"])
    other_seed = data.DeviceImageryShards(img=32, batch=4, seed=1,
                                          device=CPU)
    assert not torch.equal(other_seed(2, 5)["images"], a["images"])


def test_eager_call_equals_the_call_inside_the_loop():
    """The device loop passes (1,)-shaped slot tensors and int32 cursor
    tensors (``bidx + j``); the host engine passes ints."""
    sat = torch.arange(8, dtype=torch.int64)[3:4]
    bidx = torch.zeros((), dtype=torch.int32) + 7
    loop = SHARDS(sat, bidx + 2)
    host = SHARDS.batch_at(3, 9)
    for k in host:
        assert torch.equal(loop[k], host[k])


def test_contract_matches_the_reference_provider():
    want = jdata.DeviceImageryShards(img=32, batch=4)(0, 0)
    got = SHARDS(0, 0)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape)
        assert np.dtype(str(got[k].dtype).removeprefix("torch.")) == \
            np.dtype(want[k].dtype)
    meta = SHARDS.meta_batch()
    for k in got:
        assert meta[k].shape == got[k].shape and meta[k].dtype == \
            got[k].dtype and meta[k].device.type == "meta"
    labels = torch.cat([SHARDS(s, i)["labels"] for s in range(6)
                        for i in range(6)])
    assert labels.min() >= 0 and labels.max() < SHARDS.n_classes
    imgs = torch.cat([SHARDS(s, 0)["images"] for s in range(6)])
    assert torch.isfinite(imgs).all() and imgs.abs().max() < 2.0
    prior = SHARDS.prior(1)
    assert prior.dtype == torch.float64
    assert torch.all(prior >= 0) and abs(float(prior.sum()) - 1.0) < 1e-12


def test_satellites_are_non_iid():
    def hist(sat):
        labels = torch.cat([SHARDS(sat, i)["labels"] for i in range(60)])
        return np.bincount(labels.numpy(), minlength=SHARDS.n_classes)

    h0, h1 = hist(0), hist(1)
    assert h0.sum() == h1.sum() == 240
    # total variation distance between the two satellites' label mixes
    assert 0.5 * np.abs(h0 / 240 - h1 / 240).sum() > 0.3


def test_uniforms_and_normals_are_well_formed():
    u = data.uniforms(7, 200_000, CPU)
    assert 0.0 < float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 5e-3
    z = data.box_muller(data.uniforms(8, 200_002, CPU))
    assert z.shape == (200_002,)
    assert abs(float(z.mean())) < 1e-2 and abs(float(z.std()) - 1.0) < 1e-2
    # any element can be drawn alone: a prefix is the same numbers
    assert torch.equal(data.uniforms(7, 10, CPU), u[:10])
    # no two elements of one key, nor the same element of two keys, hash
    # alike over a full batch's worth of draws
    h = data._hash32(torch.arange(1 << 20, dtype=torch.int64))
    assert torch.unique(h).numel() == 1 << 20
    assert not torch.equal(data.uniforms(9, 64, CPU), data.uniforms(10, 64,
                                                                    CPU))


def test_energy_state_matches_reference():
    N, cap = 5, 200.0
    st = es.init_energy_state(N, cap, device=CPU)
    jst = jes.init_energy_state(N, cap)
    steps = [(0, 48.25, 240.1, True), (3, 80.0, 301.0, True),
             (3, 500.0, 700.0, True), (1, 10.0, 20.0, False)]
    for sat, drain, total, trained in steps:
        st = es.apply_pass(st, torch.tensor([sat]), torch.tensor([drain]),
                           torch.tensor([total]), cap, torch.tensor(trained))
        jst = jes.apply_pass(jst, sat, jnp.float32(drain),
                             jnp.float32(total), cap, trained)
        st = es.recharge(st, 0.75, cap)
        jst = jes.recharge(jst, jnp.float32(0.75), cap)
    st = es.recharge(st, 5.0, cap, sunlit=False)
    jst = jes.recharge(jst, jnp.float32(5.0), cap, sunlit=False)
    st = es.apply_serve(st, 2, 12.5, cap)
    jst = jes.apply_serve(jst, 2, 12.5, cap)
    for got, want in zip(st, jst):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert st.n_sats == N


@pytest.mark.parametrize("img,batch", [(224, 8), (32, 2)])
def test_full_size_shapes(img, batch):
    shards = data.DeviceImageryShards(img=img, batch=batch, device=CPU)
    b = shards(4, 11)
    assert tuple(b["images"].shape) == (batch, img, img, 3)
    assert b["images"].dtype == torch.float32
    assert b["labels"].dtype == torch.int32
