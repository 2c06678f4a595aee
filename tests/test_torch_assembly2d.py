"""The port's 2D slice as a whole vs the JAX package, on the CPU.

A 2D volume is the flat-z volume (1, H, W) with patchshape (1, p, p) on
both sides.  The JAX package runs ``engine="jax"``, which takes the XLA
scan on a CPU; the port runs with ``device="cpu"``, where its wrappers take
the plain versions of the 2D kernels.  Two [vote_instances] settings: (A)
the 2D bench's (mws, sparse-data cover) and (B) configs/bbbc010.toml's
(label propagation, dense-data cover, overlaps, no single-patch
components).  Instance maps must be equal up to relabelling; the cover
selection and the component lists must be equal, in order.  Models: 1e-5
absolute in float32 (narrow widths, so sums are short).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchperpix_tpu.assembly import VoteInstancesParams as JParams
from patchperpix_tpu.assembly import to_instance_seg as jax_assemble
from patchperpix_tpu.infer.fused import decode_volume_device as jax_decode
from patchperpix_tpu.infer.fused import predict_volume_device as jax_predict
from patchperpix_tpu.models import PPPConfig as JConfig
from patchperpix_tpu.models import PPPModel as JModel
from patchperpix_tpu.ops import cover as jcover
from patchperpix_tpu.ops import graph_device as jgraph
from patchperpix_tpu.ops import np_reference as jref
from patchperpix_tpu.ops import synthetic as jsynthetic
from patchperpix_tpu_torch import weights
from patchperpix_tpu_torch.assembly import (VoteInstancesParams,
                                            to_instance_seg)
from patchperpix_tpu_torch.infer.fused import (decode_volume_device, lift_2d,
                                               predict_volume_device)
from patchperpix_tpu_torch.models import PPPConfig
from patchperpix_tpu_torch.ops import cover as tcover
from patchperpix_tpu_torch.ops import np_reference as tref
from patchperpix_tpu_torch.ops import synthetic
from patchperpix_tpu_torch.ops.graph_device import graph_components_device

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SETTINGS = {
    "A": dict(patch_threshold=0.5, fc_threshold=0.5, mws=True,
              select_patches_for_sparse_data=True),
    "B": dict(patch_threshold=0.9, fc_threshold=0.5, mws=False,
              select_patches_for_sparse_data=False,
              includeSinglePatchCCS=False, removeIntersection=True,
              overlapping_inst=True, skeletonize_foreground=False,
              numinst_threshs=(0.9, 0.1)),
}


def same_up_to_relabelling(a, b) -> bool:
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    if not np.array_equal(a == 0, b == 0):
        return False
    pairs = np.unique(np.stack([a, b], 1), axis=0)
    return len(np.unique(pairs[:, 0])) == len(pairs) == \
        len(np.unique(pairs[:, 1]))


def _three_blobs():
    labels = np.zeros((1, 40, 46), np.int32)
    labels[0, 6:12, 5:30] = 1          # two elongated blobs + one square
    labels[0, 20:26, 12:40] = 2
    labels[0, 30:38, 4:12] = 3
    crossing = np.zeros(labels.shape, bool)
    crossing[0, 22:24, 20:23] = True
    return labels, crossing, (1, 5, 5)


def _small_worms():
    labels, crossing = synthetic.worm_labels(72, 176, n_worms=3, seed=1,
                                             with_crossings=True)
    return labels, crossing, (1, 25, 25)


def _inputs(make, setting):
    labels, crossing, ps = make()
    fg = labels > 0
    numinst = fg.astype(np.uint8)
    if SETTINGS[setting].get("overlapping_inst"):
        numinst[crossing] = 2
    affs = synthetic.labels_to_affinities(labels, np.array(ps))
    return labels, fg, numinst, affs, ps


@pytest.mark.parametrize("setting", ["A", "B"])
@pytest.mark.parametrize("make", [_three_blobs, _small_worms])
def test_assembly_2d_matches_jax(make, setting):
    labels, fg, numinst, affs, ps = _inputs(make, setting)
    kw = dict(patchshape=ps, **SETTINGS[setting])
    want, _ = jax_assemble(affs, fg, fg.copy(), numinst,
                           JParams(engine="jax", **kw))
    want = np.asarray(want)
    inter, timings = {}, {}
    got, fg_out = to_instance_seg(affs, fg, fg.copy(), numinst,
                                  VoteInstancesParams(**kw), device="cpu",
                                  timings=timings, intermediates=inter)
    assert got.dtype == np.uint16 and got.shape == labels.shape
    assert np.array_equal(fg_out, fg)
    assert len(np.unique(want)) - 1 == int(labels.max()) == \
        len(np.unique(got)) - 1
    assert same_up_to_relabelling(got, want)
    assert set(timings) == {"consensus", "rank", "cover", "thin_cover",
                            "pairs", "graph", "mws_paint"}
    assert inter["n_components"] == int(labels.max())


def test_assembly_2d_noisy_affinities_match_jax():
    """Noisy affinities (no ties to hide an off-by-one in the canonical
    gate) through both, setting (B) without the single-patch filter."""
    labels, crossing, ps = _three_blobs()
    rng = np.random.RandomState(0)
    affs = synthetic.labels_to_affinities(labels, np.array(ps))
    affs = np.clip(affs * 0.9 + 0.1 * rng.rand(*affs.shape), 0, 1).astype(
        np.float32)
    fg = labels > 0
    numinst = fg.astype(np.uint8)
    numinst[crossing] = 2
    kw = dict(patchshape=ps, **{**SETTINGS["B"], "patch_threshold": 0.6,
                                "includeSinglePatchCCS": True})
    want, _ = jax_assemble(affs, fg, fg.copy(), numinst,
                           JParams(engine="jax", **kw))
    got, _ = to_instance_seg(affs, fg, fg.copy(), numinst,
                             VoteInstancesParams(**kw), device="cpu")
    assert len(np.unique(want)) >= 4
    assert same_up_to_relabelling(got, np.asarray(want))


def test_to_instance_seg_2d_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    labels, fg, numinst, affs, ps = _inputs(_three_blobs, "B")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_instance_seg(affs, fg, fg.copy(), numinst,
                        VoteInstancesParams(patchshape=ps, **SETTINGS["B"]))


@pytest.mark.parametrize("make,fc", [(_three_blobs, 0.5), (_small_worms, 0.5),
                                     (_small_worms, 0.7)])
def test_dense_cover_2d_matches_jax(make, fc):
    """The dense-data cascade on a 2D image: the port's selection equals
    the JAX package's for the same ranked list."""
    labels, crossing, ps = make()
    rng = np.random.RandomState(2)
    affs = synthetic.labels_to_affinities(labels, np.array(ps))
    affs = np.clip(affs * 0.8 + 0.2 * rng.rand(*affs.shape), 0, 1).astype(
        np.float32)
    fg = labels > 0
    cand = np.argwhere(fg & tref.interior(fg.shape, np.array(ps) // 2))
    scores = rng.rand(len(cand)).astype(np.float32)
    scores[::5] = scores[2]                 # ties keep scan order
    order = np.argsort(-scores, kind="stable")
    ranked = [(cand[i], float(scores[i])) for i in order]
    overlap = crossing.astype(np.uint8)
    mask = fg & ~crossing
    want, want_run = jcover.greedy_cover_device(
        affs, mask, ranked, ps, fc_threshold=fc, overlap=overlap,
        sparse_data=False)
    got, got_run = tcover.greedy_cover_device(
        torch.from_numpy(affs), mask, ranked, ps, fc_threshold=fc,
        overlap=overlap, sparse_data=False)
    assert 0 < len(want) < len(ranked)
    np.testing.assert_array_equal([c for c, _ in got], [c for c, _ in want])
    assert [s for _, s in got] == [s for _, s in want]
    np.testing.assert_array_equal(got_run, np.asarray(want_run))


def _random_graph(seed, n_nodes=60, n_edges=90, ndim=3):
    rng = np.random.RandomState(seed)
    nodes = rng.randint(0, 50, size=(n_nodes, ndim))
    nodes[:, 0] = 0
    e = rng.randint(0, n_nodes, size=(n_edges, 2))
    e = e[e[:, 0] != e[:, 1]]
    pairs = np.concatenate([nodes[e[:, 0]], nodes[e[:, 1]]], axis=1)
    return pairs.astype(np.uint32), rng.randn(len(e)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_graph_components_device_matches_jax(seed):
    pairs, w = _random_graph(seed)
    want = jgraph.graph_components_device(pairs, w)
    got = graph_components_device(pairs, w, device="cpu")
    assert 3 < len(want) < 60
    assert got == want                      # component and member order
    assert got == jref.graph_components(pairs, w, mws=False)


def test_graph_components_device_all_negative_and_chain():
    pairs, w = _random_graph(3)
    assert graph_components_device(pairs, -np.abs(w) - 1, device="cpu") == []
    assert jgraph.graph_components_device(pairs, -np.abs(w) - 1) == []
    # a long chain given back to front: many propagation rounds
    n = 200
    nodes = np.stack([np.zeros(n, int), np.arange(n), np.arange(n) * 2], 1)
    pairs = np.concatenate([nodes[1:], nodes[:-1]], axis=1)[::-1]
    w = np.ones(n - 1, np.float32)
    got = graph_components_device(pairs, w, device="cpu")
    assert got == jgraph.graph_components_device(pairs, w)
    assert len(got) == 1 and len(got[0]) == n


def test_synthetic_copies_equal_the_jax_package():
    spec = importlib.util.spec_from_file_location(
        "bench_2d", os.path.join(REPO, "scripts", "bench_2d.py"))
    bench_2d = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_2d)
    for h, w, n, seed in ((72, 176, 3, 1), (520, 696, 16, 0)):
        labels, crossing = synthetic.worm_labels(h, w, n, seed,
                                                 with_crossings=True)
        np.testing.assert_array_equal(labels,
                                      bench_2d.worm_labels(h, w, n, seed))
        np.testing.assert_array_equal(synthetic.worm_labels(h, w, n, seed),
                                      labels)
        assert crossing.dtype == bool and not crossing[labels == 0].any()
    assert crossing.sum() > 0               # the full image has crossings
    labels, _, ps = _three_blobs()
    np.testing.assert_array_equal(
        synthetic.labels_to_affinities(labels, np.array(ps)),
        jsynthetic.labels_to_affinities(labels, np.array(ps)))


# ---- 2D models -----------------------------------------------------------

def _narrow_2d(upsampling="trans_conv", ae_upsampling="resize_conv"):
    return dict(patchshape=(1, 5, 5), num_channels=1, num_fmaps=4,
                fmap_inc_factors=(2, 2), fmap_dec_factors=(1.0, 1.0),
                downsample_factors=((1, 2, 2), (1, 2, 2)), kernel_size=3,
                num_repetitions=2, padding="same", upsampling=upsampling,
                overlapping_inst=True, max_num_inst=2, train_code=True,
                code_units=18, ae_code_fmaps=2, ae_num_fmaps=(3, 4),
                ae_downsample_factors=((2, 2), (2, 2)), ae_kernel_size=3,
                ae_num_repetitions=2, ae_upsampling=ae_upsampling,
                dtype="float32")


def _seeded_params(jm, size, seed=0):
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 1, size, size), jnp.float32),
                        method=jm.full_init))
    leaves = sorted(("/".join(str(getattr(k, "key", k)) for k in path),
                     v.shape)
                    for path, v in jax.tree_util.tree_leaves_with_path(shapes))
    flat = weights.seeded_tree(leaves, seed)
    tree = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(val)
    return flat, tree


@pytest.mark.parametrize("upsampling,ae_upsampling", [
    ("trans_conv", "resize_conv"), ("resize_conv", "trans_conv")])
def test_models_2d_match_flax(upsampling, ae_upsampling):
    """2D U-Net, heads and conv decoder against Flax through weights.py
    (seeded_tree feeds both sides the same leaves)."""
    kw = _narrow_2d(upsampling, ae_upsampling)
    jm = JModel(JConfig(**kw))
    flat, tree = _seeded_params(jm, 16)
    cfg = PPPConfig(**kw)
    assert cfg.spatial_dims == 2
    model = weights.build_model(cfg, flat, device="cpu")
    assert isinstance(model.head_code_affs, torch.nn.Conv2d)
    raw = np.random.RandomState(4).rand(2, 1, 16, 24).astype(np.float32)
    j1, j2 = jm.apply(tree, raw)
    with torch.no_grad():
        t1, t2 = model(torch.from_numpy(raw))
    assert t1.shape == j1.shape == (2, 18, 16, 24) and t2.shape == j2.shape
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), atol=1e-5)
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), atol=1e-5)
    codes = np.random.RandomState(5).rand(6, 18).astype(np.float32)
    jd = jm.apply(tree, codes, method=JModel.decode)
    with torch.no_grad():
        td = model.decode(torch.from_numpy(codes))
    assert td.shape == jd.shape == (6, 5, 5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)


def test_fused_2d_window_matches_jax_and_lifts():
    """predict -> decode on a 2D window through both packages' fused entry
    points, then the lift to the flat-z layout the assembly takes."""
    kw = _narrow_2d()
    jcfg, cfg = JConfig(**kw), PPPConfig(**kw)
    jm = JModel(jcfg)
    flat, tree = _seeded_params(jm, 16)
    model = weights.build_model(cfg, flat, device="cpu")
    raw = np.random.RandomState(6).rand(1, 16, 24).astype(np.float32)
    win = (16, 24)
    jcode, jprob = jax_predict(jm, tree, raw, jcfg, win, win)
    code, prob = predict_volume_device(model, raw, cfg, win, win,
                                       device="cpu")
    np.testing.assert_allclose(code.numpy(), np.asarray(jcode), atol=1e-5)
    np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), atol=1e-5)
    fg = np.random.RandomState(7).rand(*win) > 0.6
    jdec = np.asarray(jax_decode(jm, tree, jcode, fg, jcfg))
    dec = decode_volume_device(model, code, fg, cfg, device="cpu")
    assert tuple(dec.shape) == jdec.shape == (25,) + win
    np.testing.assert_allclose(dec.numpy(), jdec, atol=1e-5)
    dec4, fg3, same = lift_2d(dec, fg, fg[None])
    assert tuple(dec4.shape) == (25, 1) + win and fg3.shape == (1,) + win
    assert same.shape == (1,) + win
    numinst = fg3.astype(np.uint8)
    inst, _ = to_instance_seg(
        dec4, fg3, fg3.copy(), numinst,
        VoteInstancesParams(patchshape=(1, 5, 5), **SETTINGS["B"]),
        device="cpu")
    want, _ = jax_assemble(
        jdec[:, None], fg3, fg3.copy(), numinst,
        JParams(engine="jax", patchshape=(1, 5, 5), **SETTINGS["B"]))
    assert inst.shape == (1,) + win
    assert same_up_to_relabelling(inst, np.asarray(want))
