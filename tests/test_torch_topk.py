"""The port's top-k (cvt_tpu_torch/ops/topk.py) held against a stable sort
and against `jax.lax.top_k` (cvt_tpu.ops.topk), on the CPU.

The selection keeps the elements torch.topk returns strictly better than
the k-th value, fills the k with the lowest-index elements equal to it,
and orders those k by (value, index). Short rows and small calls stay on
the full stable sort; the `dispatch` fixture's "selection" case lowers
those limits to 0, so that the selection runs at the tests' sizes.
Tolerance: none; values and ids bitwise. Inputs are tie-heavy: int32
packed keys over a few distinct values with INT32_MAX padding, their
float32 casts, and float32 rows with +inf padding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvt_tpu.ops import topk as jtopk
from cvt_tpu_torch.ops import topk

INT32_MAX = 2 ** 31 - 1


def _inputs(kind: str, shape, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "int32_keys":
        # packed (score << 7 | lane) keys over few scores: heavy ties,
        # with INT32_MAX fill keys as the kernels write them
        x = (rng.integers(0, 6, shape) << 7) | rng.integers(0, 3, shape)
        x = x.astype(np.int32)
        x[rng.random(shape) < 0.2] = INT32_MAX
        return x
    if kind == "float32_cast":
        return _inputs("int32_keys", shape, seed).astype(np.float32)
    if kind == "inf_padded":
        x = rng.integers(-4, 4, shape).astype(np.float32) * 0.25
        x[..., shape[-1] // 2:] = np.inf       # a padded chunk's tail
        x[rng.random(shape) < 0.1] = np.inf
        return x
    raise ValueError(kind)


@pytest.fixture(params=["default", "selection"])
def dispatch(request, monkeypatch):
    if request.param == "selection":
        monkeypatch.setattr(topk, "_SORT_MAX_ROW", 0)
        monkeypatch.setattr(topk, "_SORT_MAX_ELEMS", 0)
    return request.param


def _stable(x: torch.Tensor, k: int, largest: bool):
    v, i = torch.sort(x, dim=-1, descending=largest, stable=True)
    return v[..., :k], i[..., :k]


def _lax(x: np.ndarray, k: int, largest: bool):
    f = jtopk.top_k_largest if largest else jtopk.top_k_smallest
    v, i = f(jnp.asarray(x), k)
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize("largest", [False, True])
@pytest.mark.parametrize("k", [1, 10, "N"])
@pytest.mark.parametrize("kind", ["int32_keys", "float32_cast",
                                  "inf_padded"])
def test_topk_equals_stable_sort_and_lax(kind, k, largest, dispatch):
    x = _inputs(kind, (6, 257))
    k = x.shape[-1] if k == "N" else k
    f = topk.top_k_largest if largest else topk.top_k_smallest
    v, i = f(torch.from_numpy(x), k)
    sv, si = _stable(torch.from_numpy(x), k, largest)
    assert torch.equal(v, sv) and torch.equal(i, si)
    lv, li = _lax(x, k, largest)
    np.testing.assert_array_equal(v.numpy(), lv)
    np.testing.assert_array_equal(i.numpy(), li)


@pytest.mark.parametrize("largest", [False, True])
def test_topk_leading_dims_and_single_column(largest, dispatch):
    f = topk.top_k_largest if largest else topk.top_k_smallest
    x = torch.from_numpy(_inputs("int32_keys", (2, 3, 4, 300), seed=1))
    for k in (1, 7, 74, 75, 300):      # both sides of the full-sort share
        v, i = f(x, k)
        sv, si = _stable(x, k, largest)
        assert torch.equal(v, sv) and torch.equal(i, si), k
    one = torch.from_numpy(_inputs("inf_padded", (5, 1), seed=2))
    v, i = f(one, 1)
    assert torch.equal(v, one) and torch.equal(i, torch.zeros_like(i))


def test_topk_all_equal_and_k_zero(dispatch):
    """Every element ties with the k-th value: the first k indices."""
    x = torch.full((3, 1000), 7, dtype=torch.int32)
    v, i = topk.top_k_smallest(x, 10)
    assert torch.equal(i, torch.arange(10).expand(3, 10))
    v, i = topk.top_k_largest(x.float(), 10)
    assert torch.equal(i, torch.arange(10).expand(3, 10))
    v, i = topk.top_k_smallest(x, 0)
    assert v.shape == (3, 0) and i.shape == (3, 0)


def test_merge_topk_and_chunked_scan_keep_ids(rng, dispatch):
    """Callers keep their ids: merge_topk over tied candidate lists and
    the chunked exact scan agree with cvt_tpu bitwise."""
    d = rng.integers(0, 5, (8, 96)).astype(np.float32)
    ids = rng.permutation(8 * 96).reshape(8, 96).astype(np.int32)
    for largest in (False, True):
        v, i = topk.merge_topk(torch.from_numpy(d), torch.from_numpy(ids),
                               10, largest=largest)
        jv, ji = jtopk.merge_topk(jnp.asarray(d), jnp.asarray(ids), 10,
                                  largest=largest)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    # duplicated database rows: every distance ties in pairs
    db = np.repeat(rng.integers(0, 4, (300, 8)).astype(np.float32), 2, 0)
    q = rng.integers(0, 4, (5, 8)).astype(np.float32)
    dd, ii = topk.chunked_topk_scan(torch.from_numpy(q), torch.from_numpy(db),
                                    10, chunk=128)
    jd, ji = jtopk.chunked_topk_scan(jnp.asarray(q), jnp.asarray(db), 10,
                                     chunk=128)
    np.testing.assert_array_equal(ii.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(dd.numpy(), np.asarray(jd))


def test_topk_selection_at_its_default_limits():
    """A call above both limits takes the selection by default: [80,
    65,536] tie-heavy rows with +inf padding, like the SQ scan's chunk."""
    x = torch.from_numpy(_inputs("inf_padded", (80, 65_536), seed=3))
    assert x.shape[-1] > topk._SORT_MAX_ROW
    assert x.numel() > topk._SORT_MAX_ELEMS
    for k in (1, 10):
        v, i = topk.top_k_smallest(x, k)
        sv, si = _stable(x, k, False)
        assert torch.equal(v, sv) and torch.equal(i, si)
