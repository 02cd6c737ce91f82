"""cvt_tpu_torch.train held against cvt_tpu.train on the CPU.

The ArcFace parameters are drawn by `cvt_tpu.train.create_state`
(jax.random) and carried across by `convert.arcface_from_numpy`; inputs
are numpy draws handed to both packages. The test inputs keep every
cosine away from the clip at 1 - 1e-7, where jnp.clip's and torch.clamp's
gradients differ.

Tolerances: logits, loss and gradients rtol 1e-5 (float32 products and
sums in another order; logits and gradients also atol 1e-5 of their
largest magnitude, for entries near 0); parameters after 5 Adam steps
against optax.adam atol 1e-5 (the same update, rounded in another order);
the data-parallel step on 4 gloo ranks against one step on the whole
batch, SGD, loss 1e-4 and parameters atol 1e-5 (tests/test_train.py:72's
bars). Record files byte-equal both ways, batches equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_dist_workers as W
from cvt_tpu.train import arcface as J
from cvt_tpu.train import records as JR
from cvt_tpu_torch import convert
from cvt_tpu_torch.train import (RecordDataset, RecordWriter, arcface_logits,
                                 arcface_loss, create_state, embed,
                                 parameters, state_from_params, train_step)

WORLD = 4


def _toy_data(rng, n_per_class=40, num_classes=4, dim=16):
    """tests/test_train.py's class-structured data."""
    centers = rng.normal(size=(num_classes, dim)).astype(np.float32) * 3
    xs, ys = [], []
    for c in range(num_classes):
        xs.append(centers[c] + rng.normal(size=(n_per_class, dim)).astype(
            np.float32))
        ys.append(np.full(n_per_class, c, np.int32))
    return np.concatenate(xs), np.concatenate(ys)


def _leaves(p) -> list:
    """cvt_tpu's parameter pytree in the port's `parameters` order."""
    out = []
    for lyr in p["layers"]:
        out += [np.asarray(lyr["w"]), np.asarray(lyr["b"])]
    return out + [np.asarray(p["head"])]


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def carried():
    """cvt_tpu's state (16 -> 12 -> 8, 6 classes) and the same numbers
    as the port's parameters on the CPU; a batch whose cosines stay
    inside the clip."""
    st, opt = J.create_state(jax.random.PRNGKey(3), dim_in=16,
                             num_classes=6, dim_emb=8, hidden=(12,))
    p = jax.tree.map(np.asarray, st.params)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(24, 16)).astype(np.float32)
    y = rng.integers(0, 6, size=24).astype(np.int32)
    cos = np.asarray(J.arcface_logits(st.params, x, y, scale=1.0,
                                      margin=0.0))
    assert np.abs(cos).max() < 0.99
    return st, opt, p, x, y


@pytest.mark.parametrize("margin", [0.5, 2.9])
def test_logits_loss_and_grads_match_reference(carried, margin):
    """margin 2.9 takes the easy-margin branch (theta + m >= pi) for
    targets whose angle is wide."""
    st, _, p, x, y = carried
    params = convert.arcface_from_numpy(p, device="cpu")
    state, _ = state_from_params(params)
    kw = dict(scale=30.0, margin=margin)
    _close(arcface_logits(state.params, x, y, **kw).detach(),
           J.arcface_logits(st.params, x, y, **kw))
    loss, grads = jax.value_and_grad(J.arcface_loss)(st.params, x, y, **kw)
    t_loss = arcface_loss(state.params, x, y, **kw)
    t_loss.backward()
    np.testing.assert_allclose(float(t_loss.detach()), float(loss),
                               rtol=1e-5)
    for got, want in zip(parameters(state.params), _leaves(grads)):
        _close(got.grad, want)
    _close(embed(state.params, x), J.embed(st.params, jnp.asarray(x)))


def test_adam_steps_match_optax(carried):
    """Five steps of the default optimizer (Adam 1e-3) against
    optax.adam(1e-3), the losses each step and the parameters after."""
    st, opt, p, x, y = carried
    state, t_opt = state_from_params(convert.arcface_from_numpy(
        p, device="cpu"))
    assert isinstance(t_opt, torch.optim.Adam)
    for _ in range(5):
        st, loss = J.train_step(st, x, y, opt)
        state, t_loss = train_step(state, x, y, t_opt)
        np.testing.assert_allclose(float(t_loss), float(loss), rtol=1e-5)
    assert state.step == st.step == 5
    for got, want in zip(parameters(state.params), _leaves(st.params)):
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)


def test_arcface_loss_decreases():
    """tests/test_train.py:54 on the port's own initialisation."""
    rng = np.random.default_rng(0)
    x, y = _toy_data(rng)
    state, opt = create_state(0, dim_in=16, num_classes=4, dim_emb=8,
                              optimizer=lambda p: torch.optim.Adam(p,
                                                                   lr=1e-2),
                              device="cpu")
    loss0 = float(arcface_loss(state.params, x, y).detach())
    for _ in range(30):
        state, loss = train_step(state, x, y, opt)
    assert float(loss) < loss0 * 0.5
    emb = embed(state.params, x).numpy()
    sim = emb @ emb.T
    same = sim[y[:, None] == y[None, :]].mean()
    diff = sim[y[:, None] != y[None, :]].mean()
    assert same > diff + 0.2


def test_create_state_layout():
    state, opt = create_state(torch.Generator().manual_seed(1), dim_in=10,
                              num_classes=7, dim_emb=4, hidden=(6,),
                              device="cpu")
    shapes = [tuple(t.shape) for t in parameters(state.params)]
    assert shapes == [(10, 6), (6,), (6, 4), (4,), (4, 7)]
    assert opt.defaults["lr"] == 1e-3 and opt.defaults["betas"] == (
        0.9, 0.999) and opt.defaults["eps"] == 1e-8      # optax.adam's
    again, _ = create_state(1, dim_in=10, num_classes=7, dim_emb=4,
                            hidden=(6,), device="cpu")
    for a, b in zip(parameters(state.params), parameters(again.params)):
        assert torch.equal(a, b)


def _write_both(tmp_path, x, y):
    jp, tp = tmp_path / "j.cvtr", tmp_path / "t.cvtr"
    JR.RecordDataset.from_arrays(jp, x, y)
    RecordDataset.from_arrays(tp, x, y)
    return jp, tp


def test_records_byte_equal_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(17, 8)).astype(np.float32)
    y = rng.integers(0, 5, size=17)
    jp, tp = _write_both(tmp_path, x, y)
    assert jp.read_bytes() == tp.read_bytes()
    for path in (jp, tp):
        for ds in (RecordDataset(path), JR.RecordDataset(path)):
            assert len(ds) == 17 and ds.num_classes == int(y.max()) + 1
            np.testing.assert_array_equal(ds.labels, y)
            np.testing.assert_array_equal(ds[3][0], x[3])
    # raw payloads and labels through each writer
    for writer, name in ((RecordWriter, "tw.cvtr"),
                         (JR.RecordWriter, "jw.cvtr")):
        with writer(tmp_path / name) as w:
            w.append(b"abc", 2)
            w.append(b"", 7)
            w.append(b"defg", 0)
    assert (tmp_path / "tw.cvtr").read_bytes() == (
        tmp_path / "jw.cvtr").read_bytes()
    ds = JR.RecordDataset(tmp_path / "tw.cvtr",
                          decode=lambda b: np.frombuffer(b, np.uint8))
    assert [ds.payload(i) for i in range(3)] == [b"abc", b"", b"defg"]
    assert list(ds.labels) == [2, 7, 0] and ds.num_classes == 8


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_batches_same_order_for_a_seed(tmp_path, drop_remainder):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(23, 4)).astype(np.float32)
    y = rng.integers(0, 9, size=23)
    jp, tp = _write_both(tmp_path, x, y)
    kw = dict(seed=5, epochs=2, drop_remainder=drop_remainder)
    got = list(RecordDataset(tp).batches(5, **kw))
    want = list(JR.RecordDataset(jp).batches(5, **kw))
    assert len(got) == len(want) == (8 if drop_remainder else 10)
    for (xg, yg), (xw, yw) in zip(got, want):
        np.testing.assert_array_equal(xg, xw)
        np.testing.assert_array_equal(yg, yw)
    other = next(iter(RecordDataset(tp).batches(5, seed=6)))
    assert not np.array_equal(other[1], got[0][1]) or not np.array_equal(
        other[0], got[0][0])


def test_sharded_step_on_4_ranks_equals_single(tmp_path):
    """Three data-parallel SGD steps, each rank on a quarter of the batch,
    against three steps of cvt_tpu's train_step (and the port's) on the
    whole batch."""
    rng = np.random.default_rng(1)
    x, y = _toy_data(rng, n_per_class=16)
    opt = optax.sgd(1e-2)
    st, _ = J.create_state(jax.random.PRNGKey(7), dim_in=16, num_classes=4,
                           dim_emb=8, optimizer=opt)
    p = jax.tree.map(np.asarray, st.params)
    ranks = W.spawn(tmp_path, "sharded_arcface", WORLD, dict(
        x=x, y=y, w0=p["layers"][0]["w"], b0=p["layers"][0]["b"],
        head=p["head"]))
    state, t_opt = state_from_params(
        convert.arcface_from_numpy(p, device="cpu"),
        lambda q: torch.optim.SGD(q, lr=1e-2))
    losses = []
    for _ in range(3):
        st, loss = J.train_step(st, x, y, opt)
        state, _ = train_step(state, x, y, t_opt)
        losses.append(float(loss))
    for out in ranks:
        assert int(out["step"][0]) == 3
        np.testing.assert_allclose(out["losses"], losses, atol=1e-4)
        for j, (want, single) in enumerate(zip(_leaves(st.params),
                                               parameters(state.params))):
            np.testing.assert_allclose(out[f"p{j}"], want, atol=1e-5)
            np.testing.assert_allclose(out[f"p{j}"],
                                       single.detach().numpy(), atol=1e-5)
