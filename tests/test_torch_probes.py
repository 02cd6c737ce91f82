"""The four probes of `cvt_tpu_torch.probes` on the CPU at small sizes,
their stages against the same stages built from `cvt_tpu` on the same
seeded images, as the top-level `_prof_*.py` scripts build them.

(a) Each probe's `main([..., "--device", "cpu", "--quick"])` prints one
    JSON line per stage (name, ms, fastest and slowest window, shapes)
    and a last line with the device ("cpu") and the kernel launches (0
    here: the wrappers run their plain twins); without a card and
    without the CPU asked for, each raises.
(b) adc at N 4,096, D 32, B 128 / 256 / 512: every phase-1 shape is held
    against the twin; a tile the kernel refuses is printed with the
    refusal and the probe raises after its sweep.
(c) detect, feat and orient, stage by stage on 2 images of 64 x 80 at K
    256, each stage fed `cvt_tpu`'s upstream tensors (its pyramid) so
    that rounding does not cascade. Tolerances are those of
    tests/test_torch_features.py:
    - pyramid levels (DoG, gradients) 1e-5;
    - the 3x3x3 stencil masks and the raw top-k values of |DoG| equal
      (the max-pool equals the reduce_window exactly there);
    - `detect_octave` on `cvt_tpu`'s DoG: level and valid equal wherever
      the slot's score clears the k-th score by more than 1e-6; x / y /
      level within 1e-4, response within 1e-5;
    - the global selection by |response|: the slots whose score is more
      than 1e-5 from both neighbours' (at least 90% of the valid ones)
      hold the same octave, level and validity, x / y / level within
      1e-4 and response within 1e-5;
    - orientations on `cvt_tpu`'s keypoints: angles within 1e-3 rad
      (circular) and the same slots valid, where the histogram's best
      O + 1 peaks differ by more than 1e-3 relative; descriptors on
      `cvt_tpu`'s angles at cosine >= 0.9999;
    - the orientation gathers' sums of 512 bilinear samples, each within
      the features tests' 1e-6 of `cvt_tpu`'s: within 512 * 1e-6.
Torch runs on 2 threads, as in tests/test_torch_benches.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvt_tpu.features import descriptor as jdesc
from cvt_tpu.features import detect as jdet
from cvt_tpu.features import scale_space as jss
from cvt_tpu_torch.features import descriptor as tdesc
from cvt_tpu_torch.features.scale_space import OctavePyramid
from cvt_tpu_torch.io.datasets import procedural_images
from cvt_tpu_torch.ops.kernels import wrappers
from cvt_tpu_torch.probes import adc, detect, feat, orient
from test_torch_features import _angles_close, _hist_gap_ok, _jax_scores

B, H, W, K = 2, 64, 80, 256
PEAK = 0.02 / 3
IMAGE_ARGS = ["--batch", str(B), "--height", str(H), "--width", str(W),
              "--max-k", str(K)]
ADC_ARGS = ["--n", "4096", "--dim", "32", "--batches", "128,256,512"]
PROBES = {"adc": (adc, ADC_ARGS), "detect": (detect, IMAGE_ARGS),
          "feat": (feat, IMAGE_ARGS), "orient": (orient, IMAGE_ARGS)}
STAGES = {
    "adc": ["launch overhead", "phase1 tile=1024 B=128",
            "phase1 (search's) B=128", "full fast k=10 B=128",
            "phase1 (search's) B=256", "full fast k=10 B=256",
            "phase1 (search's) B=512", "full fast k=10 B=512",
            "phase1 tile=2048 B=128", "phase1 tile=4096 B=128"],
    "detect": ["pyramid dog only", "pyramid with grads", "pyr+stencil",
               "pyr+topk(raw)", "pyr+full detect"],
    "feat": ["pyramid", "detect+select", f"+orient({K},O=2)",
             f"+desc({2 * K})"],
    "orient": ["prep(base)", "prep+gathers only", "prep+hist/peaks only",
               "prep+orient full"]}
NO_LAUNCHES = {name: 0 for name in wrappers()}


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def t(x):
    return torch.from_numpy(np.array(x))


def n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol):
    np.testing.assert_allclose(n(got), n(want), rtol=0.0, atol=tol)


def _lines(capsys) -> list:
    out = capsys.readouterr().out.splitlines()
    assert out and all(ln.startswith("{") for ln in out), out
    return [json.loads(ln) for ln in out]


# ------------------------------------------------------- (a) the lines
@pytest.mark.parametrize("name", sorted(PROBES))
def test_probe_prints_a_line_per_stage(name, capsys):
    mod, args = PROBES[name]
    r = mod.main(args + ["--device", "cpu", "--quick", "--reps", "1"])
    *stages, last = _lines(capsys)
    assert [s["stage"] for s in stages] == STAGES[name]
    for s in stages:
        assert isinstance(s["shapes"], dict) and np.isfinite(s["ms"])
        if s["stage"] != "launch overhead":
            assert s["ms_min"] <= s["ms"] <= s["ms_max"]
    assert last == json.loads(json.dumps(r))
    assert last["suite"] == f"probes.{name}" and last["device"] == "cpu"
    assert last["kernel_launches"] == NO_LAUNCHES


@pytest.mark.parametrize("name", sorted(PROBES))
def test_probe_raises_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PROBES[name][0].main(PROBES[name][1])


# ------------------------------------------------------------- (b) adc
def test_adc_probe_holds_every_phase1_shape_against_the_twin(capsys):
    r = adc.main(ADC_ARGS + ["--device", "cpu", "--quick", "--reps", "1"])
    stages = {s["stage"]: s for s in _lines(capsys)[:-1]}
    held = [s for s in STAGES["adc"] if s.startswith("phase1")]
    assert sorted(r["twins"]) == sorted(held)
    for name in held:
        assert stages[name]["twin"] == r["twins"][name]
        assert r["twins"][name]["rows_differ"] == 0
        assert stages[name]["shapes"]["codes"] == [16384, 8]
        assert stages[name]["bound_ms"] > 0
    assert [stages[f"phase1 tile={tile} B=128"]["shapes"]["tile"]
            for tile in (1024, 2048, 4096)] == [1024, 2048, 4096]
    assert r["npad"] == 16384 and r["refused"] == {}


def test_adc_probe_reports_a_refused_tile_then_raises(capsys):
    with pytest.raises(RuntimeError, match="tiles refused"):
        adc.main(ADC_ARGS + ["--device", "cpu", "--quick", "--reps", "1",
                             "--tiles", "3072,4096"])
    lines = _lines(capsys)
    refused = [s for s in lines if "refused" in s and "stage" in s]
    assert [s["stage"] for s in refused] == ["phase1 tile=3072 B=128"]
    assert "must divide Npad 16384" in refused[0]["refused"]
    assert "ms" not in refused[0]
    # the sweep went on past the refusal, and the result line names it
    assert lines[-2]["stage"] == "phase1 tile=4096 B=128"
    assert list(lines[-1]["refused"]) == ["phase1 tile=3072 B=128"]


# ------------------------------------------ (c) stages against cvt_tpu
@pytest.fixture(scope="module")
def images():
    return procedural_images(B, H, W, seed=0)


@pytest.fixture(scope="module")
def jpyr(images):
    """cvt_tpu's pyramid of the images (first octave -1, gradients)."""
    return jss.build_pyramid(jnp.asarray(images), first_octave=-1,
                             with_gradients=True)


@pytest.fixture(scope="module")
def tpyr(jpyr):
    """The same pyramid as the port's OctavePyramid list."""
    return [OctavePyramid(t(o.gauss), t(o.dog), t(o.grad_dx), t(o.grad_dy),
                          o.octave, o.step, o.sigmas) for o in jpyr]


def test_detect_pyramid_stages(images, jpyr):
    im = t(images)
    got = detect.dogs(im)
    with_grads = detect.dogs_and_grads(im)
    assert len(got) == len(with_grads) == len(jpyr) == 4
    for d, (d2, dx, dy), o in zip(got, with_grads, jpyr):
        _close(d, o.dog, 1e-5)
        _close(d2, o.dog, 1e-5)
        _close(dx, o.grad_dx, 1e-5)
        _close(dy, o.grad_dy, 1e-5)


def test_detect_stencil_and_raw_topk_on_cvt_tpu_dogs(jpyr):
    dogs = [o.dog for o in jpyr]
    for got, d in zip(detect.stencil([t(d) for d in dogs]), dogs):
        want = (((d >= jdet._window_max(d)) & (d > PEAK))
                | ((d <= jdet._window_min(d)) & (d < -PEAK)))
        np.testing.assert_array_equal(n(got), np.asarray(want))
        assert n(got).sum() > 0
    for got, d in zip(detect.raw_topk([t(d) for d in dogs], K), dogs):
        score = jnp.abs(d).reshape(d.shape[0], -1)
        want = jax.lax.top_k(score, min(K, score.shape[1]))[0]
        np.testing.assert_array_equal(n(got), np.asarray(want))


def test_detect_octave_stage_on_cvt_tpu_dogs(jpyr):
    dogs = [o.dog for o in jpyr]
    for got, d in zip(detect.detect([t(d) for d in dogs], K), dogs):
        k = min(K, int(np.prod(d.shape[1:])))
        want = jdet.detect_octave(d, max_k=k, peak_threshold=PEAK)
        top = -np.sort(-_jax_scores(d, PEAK), axis=1)[:, :k]
        clear = np.abs(top - top[:, -1:]) > 1e-6
        np.testing.assert_array_equal(n(got[5])[clear], n(want[5])[clear])
        np.testing.assert_array_equal(n(got[3])[clear], n(want[3])[clear])
        v = clear & n(want[5])
        assert v.sum() > 0
        for i in range(3):
            _close(n(got[i])[v], n(want[i])[v], 1e-4)
        _close(n(got[4])[v], n(want[4])[v], 1e-5)


@pytest.fixture(scope="module")
def jsel(jpyr):
    """The script's detect stage on cvt_tpu's pyramid (_prof_feat.py's
    stage(im, "detect") with max_k K), as numpy: selected x, y, lf, lev,
    resp, valid, oct, sig, the sorted scores, the flat stack and its
    metadata."""
    det = {k: [] for k in feat.KEYS}
    base, hs, ws, off = [], [], [], 0
    for oi, o in enumerate(jpyr):
        l, h, w = o.grad_dx.shape[1:]
        k_oct = min(K, o.dog.shape[1] * o.dog.shape[2] * o.dog.shape[3])
        out = jdet.detect_octave(o.dog, max_k=k_oct, peak_threshold=PEAK)
        for key, v in zip(feat.KEYS, out):
            det[key].append(v)
        det["oct"].append(jnp.full(out[0].shape, oi, jnp.int32))
        base.append(off)
        hs.append(h)
        ws.append(w)
        off += l * h * w
    cat = {k: jnp.concatenate(v, 1) for k, v in det.items()}
    score = jnp.where(cat["valid"], jnp.abs(cat["resp"]), -1.0)
    top, sel = jax.lax.top_k(score, K)
    s = {k: np.asarray(jnp.take_along_axis(v, sel, 1))
         for k, v in cat.items()}
    s["sig"] = np.asarray(1.6 * 2.0 ** (jnp.asarray(s["lf"]) / 3.0))
    s["top"] = np.asarray(top)
    s["gf"] = np.asarray(jnp.concatenate(
        [jnp.stack([o.grad_dx.reshape(B, -1), o.grad_dy.reshape(B, -1)],
                   -1).reshape(B, -1) for o in jpyr], 1))
    s["meta"] = [np.asarray(m, np.int32) for m in (base, hs, ws)]
    return s


def test_feat_selection_on_cvt_tpu_pyramid(tpyr, jsel):
    got = feat.select(tpyr, K)
    top = jsel["top"]
    gap = np.minimum(np.abs(np.diff(top, axis=1, prepend=np.inf)),
                     np.abs(np.diff(top, axis=1, append=-np.inf)))
    ok = (gap > 1e-5) & jsel["valid"]
    assert ok.sum() >= 0.9 * jsel["valid"].sum() > 0
    for key in ("valid", "lev", "oct"):
        np.testing.assert_array_equal(n(got[key])[ok], jsel[key][ok])
    for key in ("x", "y", "lf", "sig"):
        _close(n(got[key])[ok], jsel[key][ok], 1e-4)
    _close(n(got["resp"])[ok], jsel["resp"][ok], 1e-5)
    gf, meta = feat.flat(tpyr)
    _close(gf, jsel["gf"], 0.0)
    for m, want in zip(meta, jsel["meta"]):
        np.testing.assert_array_equal(n(m), want)


def _orient_rows(s, o: int) -> np.ndarray:
    """Keypoint slots whose histogram peaks rank without near-ties."""
    sample = tdesc._Sampler(t(s["gf"]), *map(t, s["meta"]))
    hists = torch.cat(tdesc._orientation_rows(
        sample, t(s["x"]), t(s["y"]), t(s["sig"]), t(s["lev"]),
        t(s["oct"]), None, 16, lambda h: h))
    return _hist_gap_ok(hists, o).reshape(s["x"].shape)


def test_feat_orientations_and_descriptors_on_cvt_tpu_keypoints(jsel):
    s = jsel
    ts = {k: t(s[k]) for k in ("x", "y", "lev", "valid", "oct", "sig")}
    meta = tuple(map(t, s["meta"]))
    jargs = (s["gf"], *s["meta"], s["oct"], s["x"], s["y"], s["sig"],
             s["lev"], s["valid"])
    want = jdesc.assign_orientations_multi_flat(*jargs, n_orientations=2)
    got = feat.orient(t(s["gf"]), meta, ts)
    rows = _orient_rows(s, 2)
    assert rows[s["valid"]].mean() > 0.9
    np.testing.assert_array_equal(n(got[1])[rows], n(want[1])[rows])
    m = rows[..., None] & n(want[1])
    _angles_close(n(got[0])[m], n(want[0])[m])
    # descriptors at cvt_tpu's angles, each keypoint repeated per slot
    angs, aok = np.asarray(want[0]), np.asarray(want[1])
    rep = {k: np.repeat(s[k], 2, 1) for k in ("oct", "x", "y", "sig",
                                              "lev")}
    jd = np.asarray(jdesc.sift_descriptors_flat(
        s["gf"], *s["meta"], rep["oct"], rep["x"], rep["y"], rep["sig"],
        rep["lev"], angs.reshape(B, -1), aok.reshape(B, -1)))
    td = feat.describe(t(s["gf"]), meta, ts, t(angs), t(aok)).numpy()
    assert td.shape == jd.shape == (B, 2 * K, 128)
    v = aok.reshape(B, -1)
    np.testing.assert_array_equal(td[~v], 0.0)
    assert v.sum() > 0
    assert np.sum(td[v] * jd[v], -1).min() >= 0.9999


@pytest.fixture(scope="module")
def jprep(jpyr):
    """_prof_orient.py's prep on cvt_tpu's first octave, as numpy."""
    o0 = jpyr[0]
    x, y, lf, lev, resp, valid = jdet.detect_octave(o0.dog, max_k=K,
                                                    peak_threshold=PEAK)
    gf = jnp.stack([o0.grad_dx.reshape(B, -1),
                    o0.grad_dy.reshape(B, -1)], -1).reshape(B, -1)
    p = {"gf": gf, "x": x, "y": y, "sig": 1.6 * 2.0 ** (lf / 3.0),
         "lev": lev, "valid": valid}
    p = {k: np.asarray(v) for k, v in p.items()}
    p["hw"] = o0.grad_dx.shape[2:]
    return p


def _script_grid():
    lin = np.linspace(-1.0, 1.0, 16, dtype=np.float32)
    gx, gy = np.meshgrid(lin, lin)
    return jnp.asarray(np.stack([gx.ravel(), gy.ravel()], 1))


def test_orient_prep_on_cvt_tpu_octave(tpyr, jprep):
    got = orient.octave_prep(tpyr[0], K)
    _close(got["gf"], jprep["gf"], 0.0)
    assert [int(m) for m in got["meta"][1:]] == list(jprep["hw"])
    for key in ("valid", "lev"):
        np.testing.assert_array_equal(n(got[key]), jprep[key])
    v = jprep["valid"]
    for key in ("x", "y", "sig"):
        _close(n(got[key])[v], jprep[key][v], 1e-4)


def _tprep(p):
    h, w = p["hw"]
    out = {k: t(p[k]) for k in ("gf", "x", "y", "sig", "lev", "valid")}
    out["meta"] = (torch.zeros(1, dtype=torch.int64),
                   torch.tensor([h]), torch.tensor([w]))
    return out


def test_orient_gathers_on_cvt_tpu_prep(jprep):
    """The script's orient_gather_only: per keypoint, sum(vx) + sum(vy)
    over the 16 x 16 window through `_flat_sampler_pair`."""
    p = jprep
    h, w = p["hw"]
    sample = jdesc._flat_sampler_pair(jnp.asarray([0], jnp.int32),
                                      jnp.asarray([h], jnp.int32),
                                      jnp.asarray([w], jnp.int32))
    grid = _script_grid()

    def per_kp(gfs, xi, yi, si, li):
        u = si * 4.5 * grid[:, 0]
        v = si * 4.5 * grid[:, 1]
        vx, vy = sample(gfs, 0, li, xi + u, yi + v)
        return jnp.sum(vx) + jnp.sum(vy)
    f = jax.jit(jax.vmap(jax.vmap(per_kp, in_axes=(None, 0, 0, 0, 0))))
    want = np.asarray(f(p["gf"], p["x"], p["y"], p["sig"], p["lev"]))
    got = orient.gathers(_tprep(p))
    assert got.shape == want.shape == (B, K)
    _close(got, want, 512 * 1e-6)
    assert np.abs(want).max() > 1e-3


def test_orient_hist_peaks_on_cvt_tpu_prep(jprep):
    """The script's orient_post_only: cvt_tpu's _orientation_peaks on the
    stand-in gradients x * u + sigma, y * v + sigma."""
    p = jprep
    grid = _script_grid()

    def per_kp(xi, yi, si):
        g1 = xi * grid[:, 0] + si
        g2 = yi * grid[:, 1] + si
        wgt = jnp.exp(-(grid[:, 0] ** 2 + grid[:, 1] ** 2))
        return jdesc._orientation_peaks(g1, g2, wgt, 2, 0.8)
    f = jax.jit(jax.vmap(jax.vmap(per_kp)))
    want = f(p["x"], p["y"], p["sig"])
    got = orient.hist_peaks(_tprep(p))
    g = t(_script_grid())
    xr, yr, sr = (t(p[k]).reshape(-1, 1) for k in ("x", "y", "sig"))
    hist = tdesc._orientation_hist(xr * g[:, 0] + sr, yr * g[:, 1] + sr,
                                   torch.exp(-(g[:, 0] ** 2 + g[:, 1] ** 2)))
    rows = _hist_gap_ok(hist, 2).reshape(B, K)
    assert rows.mean() > 0.9
    np.testing.assert_array_equal(n(got[1])[rows], n(want[1])[rows])
    m = rows[..., None] & n(want[1])
    _angles_close(n(got[0])[m], n(want[0])[m])


def test_orient_full_on_cvt_tpu_prep(jprep):
    p = jprep
    h, w = p["hw"]
    meta = [np.asarray(v, np.int32) for v in ([0], [h], [w])]
    oct_i = np.zeros_like(p["lev"])
    want = jdesc.assign_orientations_multi_flat(
        p["gf"], *meta, oct_i, p["x"], p["y"], p["sig"], p["lev"],
        p["valid"], n_orientations=2)
    got = orient.orient_full(_tprep(p))
    s = dict(p, oct=oct_i, meta=meta)
    rows = _orient_rows(s, 2)
    assert rows[p["valid"]].mean() > 0.9
    np.testing.assert_array_equal(n(got[1])[rows], n(want[1])[rows])
    m = rows[..., None] & n(want[1])
    _angles_close(n(got[0])[m], n(want[0])[m])
