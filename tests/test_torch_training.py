"""The port's training substrate against the JAX package's, on the CPU.

Data bit for bit; AdamW (the reference's own optimizer tests replayed on
the port, then one update from the same params and gradients in both
packages: float32 within rtol 1e-6, bf16 within one bf16 ulp); the train
step (three steps from the same params and batches: losses within rel
1e-5, params within max abs 1e-4 at lr 1e-3, the bound of the
reference's ``test_grad_accum_matches_full_batch``) and gradient
accumulation; the port's ``train`` loses 0.3 nats in 30 steps;
checkpoints bit for bit in both directions and both codecs (zstd and
zlib), the treedef string of every family, the msgpack codec's bytes;
``distill_draft`` (two steps, draft params within 1e-4); the launcher.
Float32 smoke configs; inputs from numpy seeds; the reference's params
carried over with ``params_from_numpy``.
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402
import torch  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
import repro.training as jtr  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving import speculative as jspec  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
import repro_torch.training as ttr  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import speculative as tspec  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training.train import loss_and_grads, to_device  # noqa: E402
from repro_torch.training.tree import tree_leaves, tree_map  # noqa: E402

ARCH = "qwen3-0.6b"
BF16_ULP = 2.0 ** -7          # relative spacing of bf16 at 1.0


def _pair(arch=ARCH, dtype="float32", seed=0):
    """(jax model, jax params, port model, port params) on one draw."""
    jm = jax_build_model(jcfgs.get_smoke_config(arch).replace(dtype=dtype))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(tcfgs.get_smoke_config(arch).replace(dtype=dtype))
    return jm, jp, tm, params_from_numpy(jax.device_get(jp), device="cpu")


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32))


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_corpus_and_extras_equal_the_reference_bit_for_bit(seed):
    for vocab, seq, gb in ((100, 16, 8), (512, 33, 4)):
        jc = jtr.Syntheticcorpus(jtr.DataConfig(vocab, seq, gb, seed=seed))
        tc = ttr.Syntheticcorpus(ttr.DataConfig(vocab, seq, gb, seed=seed))
        for step in (0, 5, 17):
            for shard, n in ((0, 1), (0, 2), (1, 2), (3, 4)):
                a, b = jc.batch(step, shard, n), tc.batch(step, shard, n)
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])
    for arch in ("phi-3-vision-4.2b", "whisper-medium", ARCH):
        a = jtr.extra_inputs(jcfgs.get_smoke_config(arch), 3, seed)
        b = ttr.extra_inputs(tcfgs.get_smoke_config(arch), 3, seed)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------- optimizer
def test_adamw_first_step_is_lr_sized():
    opt = ttr.AdamW(learning_rate=ttr.constant_schedule(0.1),
                    weight_decay=0.0, grad_clip=None)
    params = {"w": torch.ones(4)}
    state = opt.init(params)
    new, state = opt.update({"w": torch.full((4,), 0.5)}, state, params)
    # bias-corrected mhat/sqrt(vhat) == 1 on the first step
    np.testing.assert_allclose(new["w"].numpy(), 0.9 * np.ones(4),
                               rtol=1e-5)


def test_grad_clip_bounds_update():
    opt = ttr.AdamW(learning_rate=ttr.constant_schedule(0.1), grad_clip=1.0,
                    weight_decay=0.0)
    params = {"w": torch.zeros(1000)}
    state = opt.init(params)
    _, state2 = opt.update({"w": torch.full((1000,), 100.0)}, state, params)
    # post-clip gradient norm is 1.0 -> mu magnitude bounded
    assert float(state2.mu["w"].abs().max()) <= 0.1 * 100.0 / 100.0 + 1e-3


def test_cosine_schedule_shape():
    lr = ttr.cosine_schedule(1.0, warmup_steps=10, total_steps=100,
                             min_ratio=0.1)
    assert float(lr(torch.tensor(0))) == 0.0
    assert float(lr(torch.tensor(10))) == pytest.approx(1.0, abs=1e-3)
    assert float(lr(torch.tensor(100))) == pytest.approx(0.1, abs=1e-3)
    for s in (0, 3, 10, 41, 100, 130):
        assert float(lr(torch.tensor(s))) == float(
            jtr.cosine_schedule(1.0, 10, 100, 0.1)(jnp.asarray(s)))


def test_global_norm():
    t = {"a": torch.full((3,), 2.0), "b": torch.zeros(5)}
    assert float(ttr.global_norm(t)) == pytest.approx(12.0 ** 0.5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference(dtype):
    """Two updates from the same params and gradients (clipped, decayed,
    under a warm-up schedule): float32 within rtol 1e-6, bf16 within one
    bf16 ulp of the parameter."""
    rng = np.random.default_rng(4)
    shapes = {"m": (6, 5), "v": (7,), "s": {"t": (2, 3, 4)}}
    p0 = {k: rng.standard_normal(s).astype(np.float32) if isinstance(s, tuple)
          else {"t": rng.standard_normal(s["t"]).astype(np.float32)}
          for k, s in shapes.items()}
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), p0)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    kw = dict(weight_decay=0.1, grad_clip=1.0)
    jopt = jtr.AdamW(learning_rate=jtr.cosine_schedule(1e-2, 2, 10), **kw)
    topt = ttr.AdamW(learning_rate=ttr.cosine_schedule(1e-2, 2, 10), **kw)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(2):
        g = jax.tree_util.tree_map(
            lambda a: (3 * rng.standard_normal(a.shape)).astype(np.float32),
            p0)
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = topt.update(params_from_numpy(g, device="cpu"), ts, tp)
        for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            assert a.dtype == (torch.float32 if dtype == "float32"
                               else torch.bfloat16)
            if dtype == "float32":
                np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6,
                                           atol=1e-7)
            else:
                ulp = BF16_ULP * np.maximum(np.abs(_np(b)), 2.0 ** -126)
                assert np.all(np.abs(_np(a) - _np(b)) <= ulp)
        for a, b in zip(tree_leaves(ts.mu) + tree_leaves(ts.nu),
                        jax.tree_util.tree_leaves((js.mu, js.nu))):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-9)
    assert int(ts.step) == int(js.step) == 2


# --------------------------------------------------------------- train step
def _batches(cfg, n, B=8, S=32, seed=1):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
            for _ in range(n)]


def _adamw_replay(p0, grad_steps, lr=1e-3, b1=0.9, b2=0.95, eps=1e-8,
                  wd=0.1, clip=1.0):
    """The reference's AdamW arithmetic in float64 over a sequence of
    gradient trees (lists of leaves), from the leaves ``p0``."""
    p = [x.astype(np.float64) for x in p0]
    m = [np.zeros_like(x) for x in p]
    v = [np.zeros_like(x) for x in p]
    for s, g in enumerate(grad_steps, 1):
        norm = np.sqrt(sum(np.sum(np.square(x, dtype=np.float64)) for x in g))
        scale = min(1.0, clip / (norm + 1e-9))
        for i, gi in enumerate(g):
            gi = gi.astype(np.float64) * scale
            m[i] = b1 * m[i] + (1 - b1) * gi
            v[i] = b2 * v[i] + (1 - b2) * gi * gi
            delta = (m[i] / (1 - b1 ** s)) / (np.sqrt(v[i] / (1 - b2 ** s))
                                               + eps)
            if p[i].ndim >= 2:
                delta = delta + wd * p[i]
            p[i] = p[i] - lr * delta
    return p


def test_train_steps_match_the_reference():
    """Three steps of AdamW at lr 1e-3 from the same params and batches.

    Every element's params are within 1e-4 of the reference's, except
    where the reference's gradient is below 3 * eps = 3e-8 at some step:
    there Adam's first update, lr * g / (|g| + eps), turns a rounding
    difference of g (the packages sum in other orders) into up to a
    tenth of lr (16 of 361,216 elements here).  So the test also replays
    the reference's AdamW in float64 over each package's gradients, which
    agree per leaf within relative L2 1e-4 at every step: every element's
    params differ by no more than that replay predicts, plus 1e-6, and the
    exempt elements are held to that alone."""
    jm, jp, tm, tp = _pair()
    p0 = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    jopt = jtr.AdamW(learning_rate=jtr.constant_schedule(1e-3))
    topt = ttr.AdamW(learning_rate=ttr.constant_schedule(1e-3))
    jstep = jax.jit(jtr.make_train_step(jm, jopt))
    jgrad = jax.jit(jax.grad(jm.loss_fn))
    tstep = ttr.make_train_step(tm, topt)
    js, ts = jopt.init(jp), topt.init(tp)
    jgs, tgs = [], []
    tiny = [np.zeros(x.shape, bool) for x in p0]
    for batch in _batches(tm.cfg, 3):
        tbatch = to_device(batch, torch.device("cpu"))
        jgs.append([np.asarray(g) for g in
                    jax.tree_util.tree_leaves(jgrad(jp, batch))])
        tgs.append([g.numpy() for g in
                    loss_and_grads(tm, tp, tbatch)[1]])
        for t, a, b in zip(tiny, tgs[-1], jgs[-1]):
            t |= np.abs(b) < 3e-8
            assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b)
        jp, js, jmet = jstep(jp, js, batch)
        tp, ts, tmet = tstep(tp, ts, tbatch)
        for k in ("loss", "grad_norm", "lr"):
            assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=1e-5)
    assert sum(t.sum() for t in tiny) <= 1e-4 * sum(t.size for t in tiny)
    predicted = [np.abs(a - b) for a, b in
                 zip(_adamw_replay(p0, tgs), _adamw_replay(p0, jgs))]
    for t, e, a, b in zip(tiny, predicted, tree_leaves(tp),
                          jax.tree_util.tree_leaves(jp)):
        d = np.abs(_np(a) - _np(b))
        assert d[~t].max(initial=0.0) < 1e-4
        assert np.all(d <= e + 1e-6)


def test_grad_accum_matches_full_batch():
    _, _, tm, tp = _pair()
    opt = ttr.AdamW(learning_rate=ttr.constant_schedule(1e-3),
                    grad_clip=None)
    batch = to_device(_batches(tm.cfg, 1, seed=2)[0], torch.device("cpu"))
    p1 = tree_map(torch.clone, tp)
    p2 = tree_map(torch.clone, tp)
    p1, _, m1 = ttr.make_train_step(tm, opt)(p1, opt.init(p1), batch)
    p2, _, m2 = ttr.make_grad_accum_step(tm, opt, n_micro=4)(
        p2, opt.init(p2), batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)
    d = max(float((a - b).abs().max())
            for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    assert d < 1e-4
    assert not any(x.requires_grad for x in tree_leaves(p1))


def test_loss_decreases_dense():
    model = build_model(tcfgs.get_smoke_config(ARCH))
    params, res = ttr.train(model, steps=30, batch_size=8, seq_len=64,
                            peak_lr=1e-3, warmup=5, device="cpu")
    assert res.steps == 30 and len(res.losses) == 30
    assert all(np.isfinite(res.losses))
    assert res.last_loss < res.first_loss - 0.3
    assert not any(x.requires_grad for x in tree_leaves(params))


# --------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip_bit_for_bit(tmp_path):
    """bf16 weights, a float32 router and int leaves come back exactly."""
    tm = build_model(tcfgs.get_smoke_config("granite-moe-1b-a400m"))
    params = tm.init(torch.Generator().manual_seed(2), device="cpu")
    params["extra"] = {"i": torch.arange(7, dtype=torch.int32),
                       "z": torch.zeros((0, 3))}
    path = os.path.join(tmp_path, "m.ckpt")
    assert tckpt.save(path, params) > 0
    with open(path, "rb") as f:
        assert f.read(4) == b"NLZS"
    got = tckpt.restore(path, params)
    for a, b in zip(tree_leaves(params), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("codec", ["NLZS", "NLZL"])
def test_checkpoints_cross_between_the_packages(tmp_path, monkeypatch, codec):
    if codec == "NLZL":     # both packages write zlib without zstandard
        monkeypatch.setattr(tckpt, "zstandard", None)
        monkeypatch.setattr(jckpt, "zstandard", None)
    jm, jp, tm, tp = _pair("granite-moe-1b-a400m", dtype="bfloat16", seed=5)
    # port -> reference
    path = os.path.join(tmp_path, "port.ckpt")
    tckpt.save(path, tp)
    with open(path, "rb") as f:
        assert f.read(4) == codec.encode()
    got = jckpt.restore(path, jax.eval_shape(lambda: jp))
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(got)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8))
    # reference -> port
    path = os.path.join(tmp_path, "ref.ckpt")
    jckpt.save(path, jp)
    with open(path, "rb") as f:
        assert f.read(4) == codec.encode()
    got = tckpt.restore(path, tp, device="cpu")
    for a, b in zip(tree_leaves(tp), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_zlib_pieces_make_one_stream(monkeypatch):
    """The parallel zlib framing: one piece gives ``zlib.compress``'s
    bytes; many pieces give one stream that stdlib zlib reads back."""
    import zlib
    data = np.random.default_rng(0).integers(0, 40, 300_000,
                                             np.uint8).tobytes()
    assert tckpt._zlib(data) == zlib.compress(data, 6)
    assert tckpt._zlib(b"") == zlib.compress(b"", 6)
    monkeypatch.setattr(tckpt, "_ZLIB_PIECE", 1 << 15)
    assert zlib.decompress(tckpt._zlib(data)) == data


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-1b-a400m",
                                  "mamba2-130m", "recurrentgemma-9b",
                                  "phi-3-vision-4.2b", "whisper-medium"])
def test_treedef_string_equals_jax(arch):
    jparams = jax.eval_shape(
        jax_build_model(jcfgs.get_smoke_config(arch)).init,
        jax.random.PRNGKey(0))
    tparams = build_model(tcfgs.get_smoke_config(arch)).init(
        torch.Generator().manual_seed(0), device="cpu")
    assert tckpt.treedef_str(tparams) == str(
        jax.tree_util.tree_structure(jparams))


def test_checkpoint_structure_mismatch_fails(tmp_path):
    path = os.path.join(tmp_path, "m.ckpt")
    tckpt.save(path, {"a": torch.zeros(2)})
    with pytest.raises(ValueError):
        tckpt.restore(path, {"a": torch.zeros(2), "b": torch.zeros(2)})
    with pytest.raises(ValueError):
        tckpt.restore(path, {"a": torch.zeros(3)})
    with pytest.raises(ValueError):
        tckpt.restore(path, {"b": torch.zeros(2)})


def test_msgpack_codec_bytes_equal_msgpack():
    payload = {"treedef": "PyTreeDef({'a': *})", "n_leaves": 70000,
               "leaves": [{"dtype": "<f4", "shape": [3, n, 2 ** 33],
                           "data": b"\x01" * n}
                          for n in (0, 1, 31, 32, 255, 256, 65535, 65536)],
               "s" * 40: "y" * 300, "u" * 70000: "é" * 20,
               "many": list(range(20)), "m": {str(i): i for i in range(20)}}
    packed = tckpt.packb(payload)
    assert packed == msgpack.packb(payload, use_bin_type=True)
    assert tckpt.unpackb(packed) == msgpack.unpackb(packed, raw=False)
    # msgpack's other int widths and signs read back too
    other = msgpack.packb({"a": [-1, -200, -70000, 2 ** 63]},
                          use_bin_type=True)
    assert tckpt.unpackb(other) == {"a": [-1, -200, -70000, 2 ** 63]}
    with pytest.raises(TypeError):
        tckpt.packb({"f": 1.5})


# ------------------------------------------------------------ distill_draft
def test_distill_draft_matches_the_reference():
    jm, jp, tm, tp = _pair()
    toks = np.random.default_rng(7).integers(
        0, tm.cfg.vocab_size, (4, 12)).astype(np.int32)
    jd, jdp = jspec.truncated_draft(jm, jp, 1)
    td, tdp = tspec.truncated_draft(tm, tp, 1)
    got = tspec.distill_draft(td, tdp, tm, tp, lambda g: toks, steps=2,
                              lr=3e-3)
    want = jspec.distill_draft(jd, jdp, jm, jp, lambda k: jnp.asarray(toks),
                               steps=2, lr=3e-3)
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert not a.requires_grad
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-4)
    # the target's own layers (the draft's were views of them) are intact
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(_np(a), _np(b))


# ----------------------------------------------------------------- launcher
def test_launcher_trains_and_its_checkpoint_restores(tmp_path, capsys):
    path = os.path.join(tmp_path, "run.ckpt")
    params = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--steps", "4", "--batch", "2", "--seq", "16",
                           "--log-every", "2", "--ckpt", path])
    out = capsys.readouterr().out
    assert out.count("[launch.train] step") == 2
    assert "4 steps in" in out and "checkpoint" in out
    got = tckpt.restore(path, params)
    for a, b in zip(tree_leaves(params), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
