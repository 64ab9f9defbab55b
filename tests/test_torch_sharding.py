"""Tensor parallelism in the port (parallel/sharding.py,
parallel/collectives.py, models/model.py under ``tp``) on the CPU, against
the JAX package.

In-process: every local leaf of the port's ``shard_params`` at tp index t
equals the data of the JAX ``shard_params`` shard at mesh coordinate
(0, t), on the 8 virtual CPU devices, with two exceptions, each held to
its own rule: the fused ``wqkv`` / ``bqkv`` are regrouped ([q_t | k_t |
v_t]), and an int4 leaf whose contraction shard would split a group of 128
stays whole.  Multi-process (gloo, this file run as a script, see
``torch_workers.py``): the collectives' gradients in a two-layer toy, the
logits of encoder + cross_kv + decoder_dense at tp 2 and tp 4 against the
JAX unsharded forward (atol 2e-4, the JAX test's limit), ``full()`` at tp
2 token for token against the JAX package (greedy, full_parallel, the
host-stepped decoder, beam 2, int8, int4), the stage API's ``decode``, and
the collective census of one ``decoder_step``."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import godot_whisper_tpu_torch as gt
from godot_whisper_tpu_torch.ops.qmatmul import QUANT_TYPES, Quant4Tensor
from godot_whisper_tpu_torch.parallel import collectives as C
from godot_whisper_tpu_torch.parallel.sharding import (
    Mesh, kept_whole, param_pspecs, quantize_pspecs, shard_params,
    unshard_params)

import torch_workers as tw

SCRIPT = os.path.abspath(__file__)
FWD_B, FWD_T = 2, 6
GATES_OPEN = dict(entropy_thold=-1e9, logprob_thold=-1e9)


def _cfg(pkg, name):
    """nano: 2 + 2 layers, width 128, 4 heads (2 text layers mark it
    distilled: no timestamps); nano-3: 3 text layers; nano-multi: the
    multilingual vocabulary at 1 + 1 layers."""
    base, dims = {"nano": ("tiny.en", (2, 2)), "nano-3": ("tiny.en", (2, 3)),
                  "nano-multi": ("tiny", (1, 1))}[name]
    return pkg.get_config(base).replace(
        n_audio_layer=dims[0], n_text_layer=dims[1], n_audio_state=128,
        n_audio_head=4, n_text_state=128, n_text_head=4, name=name)


def _fwd_inputs(cfg):
    rng = np.random.default_rng(11)
    mel = rng.standard_normal((FWD_B, 2 * cfg.n_audio_ctx, cfg.n_mels)
                              ).astype(np.float32)
    tokens = rng.integers(0, cfg.n_vocab, (FWD_B, FWD_T)).astype(np.int32)
    return mel, tokens


def _noise(seconds, seed):
    return (0.3 * np.random.default_rng(seed).standard_normal(
        int(seconds * 16000))).astype(np.float32)


def _tone(seconds):
    t = np.arange(int(seconds * 16000)) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * (220.0 + 60 * np.sin(
        2 * np.pi * 0.07 * t)) * t)
        + 0.2 * np.sin(2 * np.pi * 447.0 * t)
        * (0.5 + 0.5 * np.sin(2 * np.pi * 1.7 * t)))
    return x.astype(np.float32)


def _identity(tokens, logits):
    return None


# (config, seed, dtype, quantize, audio, params) of each full() case;
# "parallel" runs full_parallel over that many chunks, "callback" the
# host-stepped decoder
FULL_CASES = {
    "greedy": ("nano-3", 0, "float32", None, ("noise", 3.0, 7),
               dict(best_of=1, temperature_inc=0.0)),
    "parallel": ("nano-3", 0, "float32", None, ("noise", 6.0, 9),
                 dict(best_of=1, temperature_inc=0.0, parallel=2)),
    "callback": ("nano-3", 0, "float32", None, ("noise", 2.0, 10),
                 dict(best_of=1, temperature_inc=0.0,
                      logits_filter_callback=_identity)),
    "beam": ("nano-multi", 1, "float32", None, ("noise", 2.0, 8),
             dict(beam=True)),
    "int8": ("nano-3", 2, "bfloat16", "int8", ("tone", 8.0, 0),
             dict(GATES_OPEN)),
    "int4": ("nano-3", 3, "bfloat16", "int4", ("tone", 8.0, 0),
             dict(GATES_OPEN, cross_kv_int8=True)),
}


def _case_audio(spec):
    kind, seconds, seed = spec
    return _noise(seconds, seed) if kind == "noise" else _tone(seconds)


def _transcribe(pkg, ctx, name):
    """Segments of ``FULL_CASES[name]`` through ``ctx`` (either package's
    WhisperContext)."""
    kw = dict(FULL_CASES[name][5])
    audio = _case_audio(FULL_CASES[name][4])
    if kw.pop("beam", False):
        return ctx.full(pkg.beam_params(beam_size=2, best_of=2,
                                        temperature_inc=0.0, language="en"),
                        audio)
    n = kw.pop("parallel", 0)
    if n:
        return ctx.full_parallel(pkg.TranscribeParams(**kw), audio, n)
    return ctx.full(pkg.TranscribeParams(**kw), audio)


def _stage_decode(ctx):
    """The stage API on 3 s of noise: decode([sot, 440, 1201], 0), then
    the logits of decode([2333], 3)."""
    ctx.pcm_to_mel(_noise(3.0, 7))
    ctx.decode([ctx.config.token_sot, 440, 1201], 0)
    return np.asarray(ctx.decode([2333], 3))


def _view(segs):
    return [[s.t0, s.t1, s.text, [t.id for t in s.tokens]] for s in segs]


# ================================================================ workers ==
def _toy(rank, world, out):
    """The collectives in a two-layer toy at tp = world: column-parallel
    W1 (copy_to_tp on its input), row-parallel W2 (reduce_from_tp), a
    column-parallel Wg whose output is gathered (gather_from_tp).  Writes
    each rank's local gradients next to the unsharded ones, and the same
    with the first copy_to_tp left out."""
    import torch.distributed as dist
    group = C.Group(dist.group.WORLD, world, rank)
    g = torch.Generator().manual_seed(5)
    x0 = torch.randn(3, 8, generator=g, dtype=torch.float64)
    w1 = torch.randn(8, 6 * world, generator=g, dtype=torch.float64)
    w2 = torch.randn(6 * world, 8, generator=g, dtype=torch.float64)
    wg = torch.randn(8, 4 * world, generator=g, dtype=torch.float64)

    def loss_of(x, a, b, c, tp, copy_first=True):
        h = torch.tanh((C.copy_to_tp(x, tp) if copy_first else x) @ a)
        y = C.reduce_from_tp(h @ b, tp)
        z = C.gather_from_tp(C.copy_to_tp(y, tp) @ c, tp)
        return (torch.sin(z) * y.sum(-1, keepdim=True)).sum() + (y * y).sum()

    def grads(tp, copy_first=True):
        n, r = (1, 0) if tp is None else (world, rank)
        leaves = [x0.clone().requires_grad_(True)]
        for w, axis in ((w1, 1), (w2, 0), (wg, 1)):
            size = w.shape[axis] // n
            leaves.append(w.narrow(axis, r * size, size).clone()
                          .requires_grad_(True))
        loss = loss_of(*leaves, tp, copy_first)
        return [gr.tolist() for gr in torch.autograd.grad(loss, leaves)]

    res = {"full": grads(None), "tp": grads(group),
           "tp_no_copy": grads(group, copy_first=False)}
    with open(os.path.join(out, f"toy{rank}.json"), "w") as f:
        json.dump(res, f)


def _tp(rank, world, out, extra):
    """Forward logits at tp = world; at tp 2 also the full() cases and the
    census of one decoder_step."""
    from godot_whisper_tpu_torch.models import model as tm
    from godot_whisper_tpu_torch.parallel.sharding import make_mesh
    mesh = make_mesh(1, world, device="cpu")
    cfg = _cfg(gt, "nano")
    full = gt.init_params(cfg, seed=0, compute_dtype=torch.float32,
                          device="cpu")
    params = shard_params(full, mesh, cfg)
    mel, tokens = _fwd_inputs(cfg)
    tp = mesh.tp_group
    with torch.no_grad():
        enc = tm.encoder_forward(params, cfg, torch.from_numpy(mel), tp=tp)
        xkv = tm.cross_kv(params, cfg, enc, tp=tp)
        kv = tm.init_kv_cache(cfg, FWD_B, dtype=torch.float32, device="cpu",
                              tp=tp)
        pos = torch.arange(FWD_T, dtype=torch.int32).expand(FWD_B, FWD_T)
        logits, kv = tm.decoder_dense(
            params, cfg, torch.from_numpy(tokens), pos, kv, xkv,
            n_valid=torch.full((FWD_B,), FWD_T), tp=tp)
        np.save(os.path.join(out, f"logits{rank}.npy"), logits.numpy())
        if "full" not in extra:
            return
        # the census of one step after the prompt pass
        C.census.clear()
        step, _ = tm.decoder_step(
            params, cfg, torch.from_numpy(tokens[:, 0]),
            torch.full((FWD_B,), FWD_T, dtype=torch.int32), kv, xkv,
            lo=torch.zeros(FWD_B, dtype=torch.int32), slot=FWD_T, split=0,
            tp=tp)
        census = {"summary": C.census_summary(),
                  "shapes": sorted([op, list(s), n]
                                   for (op, s), n in C.census.items()),
                  "kv_numel": kv.k.numel(), "logits": list(step.shape)}

    res = {"census": census}
    for name, (cname, seed, dtype, quant, _, _) in FULL_CASES.items():
        ccfg = _cfg(gt, cname)
        ctx = gt.WhisperContext.from_params(
            ccfg, gt.init_params(ccfg, seed=seed,
                                 compute_dtype=getattr(torch, dtype),
                                 device="cpu"),
            device="cpu", quantize=quant, mesh=mesh)
        res[name] = _view(_transcribe(gt, ctx, name))
        if name == "greedy":
            np.save(os.path.join(out, f"decode{rank}.npy"),
                    _stage_decode(ctx))
    with open(os.path.join(out, f"tp{rank}.json"), "w") as f:
        json.dump(res, f)


def _worker_main(argv):
    mode, rank, world, port, out, extra = tw.worker_args(argv)
    tw.init_gloo(rank, world, port)
    {"toy": lambda: _toy(rank, world, out),
     "tp": lambda: _tp(rank, world, out, extra)}[mode]()
    import torch.distributed as dist
    dist.destroy_process_group()


# ============================================================ in-process ==
def _jax_tree(name, dtype, quant, seed=0):
    import jax.numpy as jnp
    import godot_whisper_tpu as jgwt
    from godot_whisper_tpu.models.params import init_params
    tree = init_params(_cfg(jgwt, name), seed=seed,
                       compute_dtype=getattr(jnp, dtype))
    return jgwt.WhisperContext._quantize(tree, quant) if quant else tree


def _port_tree(name, dtype, quant, seed=0):
    tree = gt.init_params(_cfg(gt, name), seed=seed,
                          compute_dtype=getattr(torch, dtype), device="cpu")
    return gt.WhisperContext._quantize(tree, quant) if quant else tree


def _jax_local(tree, name, n, t):
    """numpy data of the JAX ``shard_params`` shard at mesh (0, t)."""
    import jax
    import godot_whisper_tpu as jgwt
    from godot_whisper_tpu.parallel import sharding as js
    mesh = js.make_mesh(dp=1, tp=n)
    sharded = js.shard_params(tree, mesh, _cfg(jgwt, name))
    dev = mesh.devices[0, t]

    def pick(a):
        return next(np.asarray(s.data) for s in a.addressable_shards
                    if s.device == dev)
    return jax.tree_util.tree_map(pick, sharded)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _regrouped(x, t, n):
    s = x.shape[-1] // 3
    w = s // n
    return torch.cat([x[..., i * s + t * w:i * s + (t + 1) * w]
                      for i in range(3)], dim=-1)


LAYOUTS = [("nano", "float32", None, 2), ("nano", "float32", None, 4),
           ("nano", "bfloat16", "int8", 2), ("nano", "bfloat16", "int4", 2),
           ("nano", "bfloat16", "int4", 4)]


@pytest.mark.parametrize("name,dtype,quant,n", LAYOUTS,
                         ids=[f"{q or d}-tp{n}" for _, d, q, n in LAYOUTS])
def test_shard_layout_matches_jax(name, dtype, quant, n):
    from godot_whisper_tpu_torch.models.params import params_from_jax
    full = _port_tree(name, dtype, quant, seed=3)
    jtree = _jax_tree(name, dtype, quant, seed=3)
    specs = quantize_pspecs(param_pspecs(_cfg(gt, name)), full,
                            Mesh(dp=1, tp=n))
    seen = {"regrouped": 0, "whole": 0, "jax": 0}
    for t in range(n):
        local = shard_params(full, Mesh(dp=1, tp=n, rank=t), _cfg(gt, name))
        want = params_from_jax(_jax_local(jtree, name, n, t))
        for path, leaf in _leaves(local):
            whole, spec, j = _get(full, path), _get(specs, path), _get(
                want, path)
            if path[-1] in ("wqkv", "bqkv"):
                seen["regrouped"] += 1
                for got, w in (zip(leaf, whole) if isinstance(
                        leaf, QUANT_TYPES) else [(leaf, whole)]):
                    assert torch.equal(got, _regrouped(w, t, n)), path
            elif kept_whole(whole, spec):
                seen["whole"] += 1
                assert torch.equal(leaf.q, whole.q), path
                assert torch.equal(leaf.s, whole.s), path
                # where JAX shards q across the groups
                assert j.q.shape[-2] * n == whole.q.shape[-2], path
            else:
                seen["jax"] += 1
                for got, w in (zip(leaf, j) if isinstance(
                        leaf, QUANT_TYPES) else [(leaf, j)]):
                    assert got.dtype == w.dtype and torch.equal(got, w), path
    assert seen["jax"] > 0
    assert (seen["regrouped"] > 0) == (quant is not None)
    assert (seen["whole"] > 0) == (quant == "int4")


@pytest.mark.parametrize("s,o,n,whole", [
    (384, 384, 2, True),      # tiny.en wo at tp 2: 3 groups
    (1280, 1280, 4, True),    # large-v3 wo at tp 4: 10 groups
    (512, 128, 2, False),     # nano w1 at tp 2: 2 groups a shard
    (5120, 1280, 2, False),   # large-v3 w1 at tp 2
    (5120, 1280, 4, False),   # large-v3 w1 at tp 4
], ids=["tiny.en-wo-tp2", "large-v3-wo-tp4", "nano-w1-tp2",
        "large-v3-w1-tp2", "large-v3-w1-tp4"])
def test_int4_kept_whole_rule(s, o, n, whole):
    """An int4 contraction-sharded leaf stays whole exactly where a shard
    would split a group of 128 rows: (s / tp) % 128 != 0."""
    leaf = Quant4Tensor(q=torch.empty(1, s // 2, o, dtype=torch.uint8),
                        s=torch.empty(1, s // 128, o))
    spec = quantize_pspecs({"w": (None, "tp", None)}, {"w": leaf},
                           Mesh(dp=1, tp=n))["w"]
    assert kept_whole(leaf, spec) is whole
    assert whole == ((s // n) % 128 != 0)


def test_pspecs_cover_param_tree():
    """Every leaf has a spec of at most its rank; the spec tree's extra
    leaves are only the fused wqkv / bqkv of quantized trees (the JAX
    test_pspecs_cover_param_tree)."""
    cfg = _cfg(gt, "nano")
    params = _port_tree("nano", "float32", None)
    specs = param_pspecs(cfg)
    flat_p = dict(_leaves(params))
    flat_s = dict(_leaves(specs))
    assert set(flat_p) <= set(flat_s), set(flat_p) - set(flat_s)
    extra = set(flat_s) - set(flat_p)
    assert extra and all(p[-1] in ("wqkv", "bqkv") for p in extra), extra
    for path, leaf in flat_p.items():
        assert len(flat_s[path]) <= leaf.dim(), path


def test_pspecs_cover_quantized_fused_tree():
    """The fused int8 tree gets an exactly matching pruned spec tree, a
    (q, s) pair of specs per quantized leaf (the JAX
    test_pspecs_cover_quantized_fused_tree)."""
    pq = _port_tree("nano", "bfloat16", "int8")
    specs = quantize_pspecs(param_pspecs(_cfg(gt, "nano")), pq)
    flat_p, flat_s = dict(_leaves(pq)), dict(_leaves(specs))
    assert set(flat_p) == set(flat_s)
    for path, leaf in flat_p.items():
        if isinstance(leaf, QUANT_TYPES):
            assert type(flat_s[path]) is type(leaf), path
            for x, sp in zip(leaf, flat_s[path]):
                assert len(sp) <= x.dim(), path


@pytest.mark.parametrize("n", [2, 4])
def test_unshard_inverts_shard(n):
    cfg = _cfg(gt, "nano")
    full = _port_tree("nano", "float32", None, seed=4)
    back = unshard_params([shard_params(full, Mesh(dp=1, tp=n, rank=t), cfg)
                           for t in range(n)], cfg)
    for path, leaf in _leaves(full):
        assert torch.equal(_get(back, path), leaf), path


@pytest.mark.parametrize("n", [3, 8])
def test_tp_must_divide_heads(n):
    """The kernels attend whole heads: tp 3 (or 8) on 4 heads raises."""
    cfg = _cfg(gt, "nano")
    with pytest.raises(ValueError, match="must divide n_audio_head=4"):
        shard_params(_port_tree("nano", "float32", None), Mesh(dp=1, tp=n),
                     cfg)


def test_stream_mesh_tp_must_divide_local_world():
    """One process: tp 2 does not divide a local world of 1."""
    from godot_whisper_tpu_torch.parallel import dist
    with pytest.raises(ValueError, match="must divide the local world"):
        dist.stream_mesh(tp=2, device="cpu")
    mesh = dist.stream_mesh(tp=1, device="cpu")
    assert (mesh.dp, mesh.tp, mesh.tp_group, mesh.dp_group) == (1, 1, None,
                                                               None)


def test_collectives_are_identity_without_a_group():
    x = torch.randn(3, 4)
    C.census.clear()
    assert C.reduce_from_tp(x, None) is x
    assert C.copy_to_tp(x, None) is x
    assert C.gather_from_tp(x, None) is x
    assert not C.census


# ========================================================= multi-process ==
@pytest.fixture(scope="module")
def toy_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("toy")
    tw.run_workers(SCRIPT, "toy", 2, out, timeout=120)
    return [json.load(open(out / f"toy{r}.json")) for r in range(2)]


def _toy_slices(full, rank, n=2):
    x, w1, w2, wg = (np.asarray(a) for a in full)
    s1, s2, sg = w1.shape[1] // n, w2.shape[0] // n, wg.shape[1] // n
    return [x, w1[:, rank * s1:(rank + 1) * s1],
            w2[rank * s2:(rank + 1) * s2], wg[:, rank * sg:(rank + 1) * sg]]


@pytest.mark.parametrize("op,leaves", [("copy_to_tp", [0]),
                                       ("reduce_from_tp", [1, 2]),
                                       ("gather_from_tp", [3])])
def test_collective_gradients_match_unsharded(toy_run, op, leaves):
    """Each rank's gradient of the leaves behind ``op`` equals its slice of
    the unsharded gradient (x through copy_to_tp's backward, W1 / W2
    through reduce_from_tp's, Wg through gather_from_tp's)."""
    for rank, res in enumerate(toy_run):
        want = _toy_slices(res["full"], rank)
        for i in leaves:
            np.testing.assert_allclose(np.asarray(res["tp"][i]), want[i],
                                       rtol=1e-12, atol=1e-12)


def test_missing_copy_to_tp_is_caught(toy_run):
    """Without the copy_to_tp in front of W1, x's gradient is one rank's
    partial sum: the comparison above must fail on it."""
    for rank, res in enumerate(toy_run):
        want = _toy_slices(res["full"], rank)[0]
        got = np.asarray(res["tp_no_copy"][0])
        assert np.abs(got - want).max() > 1e-3 * np.abs(want).max()
        # the other leaves are unaffected
        np.testing.assert_allclose(np.asarray(res["tp_no_copy"][1]),
                                   _toy_slices(res["full"], rank)[1],
                                   rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    runs = {}
    for n, extra in ((2, ["full"]), (4, [])):
        out = tmp_path_factory.mktemp(f"tp{n}")
        tw.run_workers(SCRIPT, "tp", n, out, *extra, timeout=300)
        runs[n] = out
    return runs


@pytest.fixture(scope="module")
def jax_forward():
    import jax
    import jax.numpy as jnp
    import godot_whisper_tpu as jgwt
    from godot_whisper_tpu.models.model import (cross_kv, decoder_dense,
                                                encoder_forward,
                                                init_kv_cache)
    cfg = _cfg(jgwt, "nano")
    params = _jax_tree("nano", "float32", None)
    mel, tokens = _fwd_inputs(cfg)

    def fwd(p, m, t):
        enc = encoder_forward(p, cfg, m)
        xkv = cross_kv(p, cfg, enc)
        kv = init_kv_cache(cfg, FWD_B, dtype=jnp.float32)
        pos = jnp.broadcast_to(jnp.arange(FWD_T, dtype=jnp.int32),
                               (FWD_B, FWD_T))
        return decoder_dense(p, cfg, t, pos, kv, xkv, n_valid=FWD_T)[0]
    return np.asarray(jax.jit(fwd)(params, jnp.asarray(mel),
                                   jnp.asarray(tokens)))


@pytest.mark.parametrize("n", [2, 4])
def test_tp_forward_matches_jax(tp_runs, jax_forward, n):
    """Logits of encoder + cross_kv + decoder_dense on nano f32 at tp n
    equal the JAX unsharded forward within 2e-4 on every rank, and the
    ranks agree bit for bit (the all-reduced logits are replicated)."""
    got = [np.load(tp_runs[n] / f"logits{r}.npy") for r in range(n)]
    assert got[0].shape == jax_forward.shape == (FWD_B, FWD_T, 51864)
    np.testing.assert_allclose(got[0], jax_forward, atol=2e-4, rtol=0)
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])


@pytest.fixture(scope="module")
def tp2_results(tp_runs):
    return [json.load(open(tp_runs[2] / f"tp{r}.json")) for r in range(2)]


def _jax_context(name):
    import jax.numpy as jnp
    import godot_whisper_tpu as jgwt
    from godot_whisper_tpu.audio.mel import mel_filterbank
    from godot_whisper_tpu.audio.tokenizer import Tokenizer, synthetic_vocab
    from godot_whisper_tpu.decode.loop import WhisperPipeline
    cname, seed, dtype, quant, _, _ = FULL_CASES[name]
    cfg = _cfg(jgwt, cname)
    params = _jax_tree(cname, dtype, quant, seed=seed)
    return jgwt.WhisperContext(WhisperPipeline(
        cfg, params, Tokenizer(cfg, synthetic_vocab(cfg)),
        mel_filterbank(80), n_loaded=1))


@pytest.mark.parametrize("name", list(FULL_CASES))
def test_tp2_full_matches_jax(tp2_results, name):
    """``WhisperContext.full`` at tp 2 gives the JAX package's segments
    token for token (greedy on nano-3 f32, also through full_parallel over
    2 chunks and through the host-stepped decoder with an identity
    logit-filter callback; beam 2 on the multilingual nano; int8 and int4
    nano-3 with the gates open), and both ranks return the same
    segments."""
    import godot_whisper_tpu as jgwt
    want = _view(_transcribe(jgwt, _jax_context(name), name))
    assert want and any(s[3] for s in want)
    assert tp2_results[0][name] == want
    assert tp2_results[1][name] == tp2_results[0][name]


def test_tp2_stage_decode_matches_jax(tp_runs):
    """The stage API at tp 2 (``decode`` twice, the KV cache carried
    between the calls) gives the JAX package's logits within 2e-4 on
    both ranks."""
    want = _stage_decode(_jax_context("greedy"))
    for r in range(2):
        got = np.load(tp_runs[2] / f"decode{r}.npy")
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_tp2_decoder_step_census(tp2_results):
    """One decoder_step at tp 2 is 3 * n_text_layer + 2 all-reduces (the
    embedding gather, per layer the self, cross and MLP row-parallel
    reduces, the logits), the largest the (B, V) f32 logits, none of
    KV-cache size."""
    cfg = _cfg(gt, "nano")
    for res in tp2_results:
        c = res["census"]
        assert c["summary"]["count"] == 3 * cfg.n_text_layer + 2
        assert c["summary"]["by_op"] == {"gather": 1,
                                         "reduce": 3 * cfg.n_text_layer + 1}
        assert c["summary"]["max_elements"] == FWD_B * cfg.n_vocab
        assert ["reduce", [FWD_B, cfg.n_vocab], 1] in c["shapes"]
        assert c["summary"]["max_elements"] < c["kv_numel"]


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker_main(sys.argv)
