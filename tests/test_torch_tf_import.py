"""The port's TF1-checkpoint importer (``axcnn_torch.ckpt.tf_import``)
against the reference's (``axcnn.ckpt.tf_import``), on the CPU.

The name scheme: the port's ``expected_tf_names``, its keys mapped through
``convert.reference_paths``, must equal the reference's list (TF names,
reference paths, TF shapes) for six configurations; the reference's trees
come from ``jax.eval_shape``, so full depth costs no compute. The import:
on a TF ``Saver`` checkpoint written as ``tests/test_tf_import.py`` writes
one, the port's ``state_dict`` must equal the reference's import carried
through ``convert.from_axcnn``, bit for bit (tolerance 0: both copy the
stored floats), with and without EMA; ``missing`` and the errors must be
the reference's; and the port's fp32 logits on the imported weights track
the reference's ``resnet_apply`` within rtol 1e-4 and an atol of 1e-4 of
the largest logit (tests/test_torch_model.py's bound: fp32 sums
reassociated over ~50 layers).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from axcnn.ckpt import tf_import as j_tf_import
from axcnn.models.resnet import ModelConfig as JModelConfig
from axcnn.models.resnet import resnet_apply, resnet_init
from axcnn.utils.config import load_preset as j_load_preset
from axcnn_torch.ckpt import tf_import as t_tf_import
from axcnn_torch.ckpt.convert import _to_torch_layout, from_axcnn, reference_paths
from axcnn_torch.models.resnet import ModelConfig, ResNet

ASSEMBLED = dict(use_resnet_d=True, use_se_block=True, use_sk_block=True,
                 anti_alias_type="sconv")
CONFIGS = {
    "vanilla_r50": dict(num_classes=1001),
    "assembled_r50": dict(ASSEMBLED, num_classes=1001),
    "merged_sk": dict(ASSEMBLED, sk_merged_conv=True, num_classes=1001),
    "bl_resnet50": "bl_resnet50",
    "r152_kd": "assemble_resnet152_kd",
    "width_0.5": dict(ASSEMBLED, width_multiplier=0.5, num_classes=37),
}
SMALL = dict(ASSEMBLED, width_multiplier=0.125, num_classes=10)


def _kw(name):
    kw = CONFIGS[name]
    if isinstance(kw, str):  # a preset: the reference's model fields
        kw = dataclasses.asdict(j_load_preset(kw).model)
    return kw


def _reference_trees(kw):
    return jax.eval_shape(lambda k: resnet_init(k, JModelConfig(**kw)), jax.random.key(0))


def _port_entries(kw):
    """The port's names with each key as the reference's path (``@state``
    marking a BN moving statistic, as the reference's list does)."""
    cfg = ModelConfig(**kw)
    with torch.device("meta"):
        state_dict = ResNet(cfg).state_dict()
    paths = reference_paths(state_dict)
    entries = t_tf_import.expected_tf_names(cfg)
    assert sorted(k for _, k, _ in entries) == sorted(state_dict)  # every entry, once
    return [(name, paths[k] + ("@state" if k.endswith(("running_mean", "running_var")) else ""),
             shape) for name, k, shape in entries]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_expected_tf_names_match_reference(name):
    kw = _kw(name)
    params, state = _reference_trees(kw)
    want = j_tf_import.expected_tf_names(JModelConfig(**kw), params, state)
    got = _port_entries(kw)
    assert len(got) == len(want)
    assert got == want


# -- the import ----------------------------------------------------------------

@pytest.fixture(scope="module")
def tf():
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
    return pytest.importorskip("tensorflow")


def _write_tf_ckpt(tf, path, names_and_values):
    """A TF1-style ``Saver`` checkpoint, as tests/test_tf_import.py writes one."""
    with tf.Graph().as_default():
        tf_vars = [tf.compat.v1.get_variable(name, initializer=tf.constant(value))
                   for name, value in names_and_values.items()]
        saver = tf.compat.v1.train.Saver(var_list=tf_vars)
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            saver.save(sess, path)


def _values(entries, seed):
    """Seeded TF-layout values by TF name: He-scaled kernels, BN scales in
    [0.5, 1.5] (bn3's in [0.1, 0.3]), perturbed shifts, statistics and
    biases; and an EMA shadow, unlike its variable, of each trainable one."""
    rng = np.random.default_rng(seed)
    out = {}
    for tf_name, path, shape in entries:
        leaf = tf_name.rsplit("/", 1)[1]
        if leaf == "kernel":
            gain = 2.0 if len(shape) == 4 else 1.0
            v = rng.standard_normal(shape) * (gain / np.prod(shape[:-1])) ** 0.5
        elif leaf == "gamma":
            v = rng.uniform(*((0.1, 0.3) if path.endswith("bn3/gamma") else (0.5, 1.5)), shape)
        elif leaf == "moving_variance":
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        out[tf_name] = v.astype(np.float32)
        if not leaf.startswith("moving_"):
            out[tf_name + j_tf_import.EMA_SUFFIX] = (
                0.9 * v + 0.05 * rng.standard_normal(shape)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def ckpt(tf, tmp_path_factory):
    """A ``Saver`` checkpoint of the narrow assembled R50: every variable,
    its EMA shadow, and ``global_step``."""
    params, state = _reference_trees(SMALL)
    entries = j_tf_import.expected_tf_names(JModelConfig(**SMALL), params, state)
    values = _values(entries, seed=5)
    values["global_step"] = np.array(7, np.int64)
    path = str(tmp_path_factory.mktemp("tf_ckpt") / "model.ckpt-7")
    _write_tf_ckpt(tf, path, values)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), (params, state))
    return dict(path=path, entries=entries, values=values, trees=zeros)


def _imports(path, kw, trees, **kw_import):
    """(the reference's import through ``from_axcnn``, its missing list) and
    (the port's import, its missing list)."""
    jp, js, j_missing = j_tf_import.import_tf_checkpoint(
        path, JModelConfig(**kw), *trees, **kw_import)
    want = from_axcnn(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js),
                      ModelConfig(**kw))
    template = ResNet(ModelConfig(**kw), generator=torch.Generator().manual_seed(0)).state_dict()
    got, t_missing = t_tf_import.import_tf_checkpoint(path, ModelConfig(**kw), template,
                                                      **kw_import)
    return (want, j_missing), (got, t_missing), template


@pytest.mark.parametrize("use_ema", [False, True], ids=["raw", "ema"])
def test_import_equals_reference_bit_for_bit(ckpt, use_ema):
    (want, j_missing), (got, t_missing), _ = _imports(ckpt["path"], SMALL, ckpt["trees"],
                                                      use_ema=use_ema)
    assert j_missing == t_missing == []
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k
    # and the values are the checkpoint's, EMA where asked for
    bn_mean = next(k for k in got if k.endswith("running_mean"))
    kernel = "stem.conv0.weight"
    name = "resnet_model/conv2d/kernel" + (j_tf_import.EMA_SUFFIX if use_ema else "")
    np.testing.assert_array_equal(got[kernel].numpy(), ckpt["values"][name].transpose(3, 2, 0, 1))
    assert not torch.equal(got[bn_mean], torch.zeros_like(got[bn_mean]))


def test_missing_and_shape_errors_match_reference(tf, ckpt, tmp_path):
    """A checkpoint without the SE variables: ``strict=False`` gives the
    reference's ``missing`` list and keeps the port's own values there;
    ``strict=True`` raises the reference's ``KeyError``. A variable under
    another shape raises the reference's ``ValueError``."""
    values = {k: v for k, v in ckpt["values"].items()}
    se = {name for name, path, _ in ckpt["entries"] if "/se/" in path}
    partial = str(tmp_path / "partial")
    kept = {k: v for k, v in values.items() if k.split("/Exp")[0] not in se}
    tf.raw_ops.SaveV2(prefix=partial, tensor_names=list(kept), shape_and_slices=[""] * len(kept),
                      tensors=[tf.constant(v) for v in kept.values()])
    (want, j_missing), (got, t_missing), template = _imports(
        partial, SMALL, ckpt["trees"], use_ema=True, strict=False)
    assert t_missing == j_missing and sorted(t_missing) == sorted(se)
    for k in got:
        expect = template[k] if ".se." in k else want[k]
        assert torch.equal(got[k], expect), k
    errors = []
    for mod, cfg, state in ((j_tf_import, JModelConfig(**SMALL), ckpt["trees"]),
                            (t_tf_import, ModelConfig(**SMALL), (template,))):
        with pytest.raises(KeyError) as e:
            mod.import_tf_checkpoint(partial, cfg, *state)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "variables not found" in errors[0]

    bad = dict(values)
    first = ckpt["entries"][3][0]  # the stem's first BN moving mean
    bad[first] = np.zeros(5, np.float32)
    wrong = str(tmp_path / "wrong")
    tf.raw_ops.SaveV2(prefix=wrong, tensor_names=list(bad), shape_and_slices=[""] * len(bad),
                      tensors=[tf.constant(v) for v in bad.values()])
    errors = []
    for mod, cfg, state in ((j_tf_import, JModelConfig(**SMALL), ckpt["trees"]),
                            (t_tf_import, ModelConfig(**SMALL), (template,))):
        with pytest.raises(ValueError) as e:
            mod.import_tf_checkpoint(wrong, cfg, *state)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and errors[0].startswith(f"shape mismatch for {first}")


def test_imported_logits_track_reference(ckpt):
    """fp32, the narrow assembled R50, 64x64, batch 2, the EMA import; rtol
    1e-4, atol 1e-4 of the largest logit."""
    jcfg = JModelConfig(**SMALL)
    jp, js, _ = j_tf_import.import_tf_checkpoint(ckpt["path"], jcfg, *ckpt["trees"],
                                                 use_ema=True)
    model = ResNet(ModelConfig(**SMALL))
    state_dict, _ = t_tf_import.import_tf_checkpoint(ckpt["path"], ModelConfig(**SMALL),
                                                     model.state_dict(), use_ema=True)
    model.load_state_dict(state_dict)
    x = np.random.default_rng(6).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, s, x: resnet_apply(p, s, x, cfg=jcfg, train=False)[0])(
        jp, js, x))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.slow
@pytest.mark.parametrize("assembled,bl", [(False, 0), (True, 0), (True, 2)],
                         ids=["vanilla", "assembled", "big_little_assembled"])
def test_port_import_reproduces_tf_graph_logits(tf, tmp_path, assembled, bl):
    """Full depth, as tests/test_tf_import_e2e.py: a TF graph that creates its
    variables through TensorFlow's own name-uniquing, written by its
    ``Saver`` with EMA shadows; the port's import puts every variable in its
    place bit for bit and reproduces the graph's fp32 logits within that
    test's bound (a few 1e-4 of the logit scale: a 50-layer fp32 forward in
    two frameworks); the EMA import gives other logits."""
    import test_tf_import_e2e as e2e

    tf1 = tf.compat.v1
    kw = dict(num_classes=7, use_resnet_d=assembled, use_se_block=assembled,
              use_sk_block=assembled, anti_alias_type="sconv" if assembled else "none",
              bl_alpha=bl, bl_beta=bl * 2)
    cfg = ModelConfig(**kw)
    rng = np.random.default_rng(3 if assembled else 2)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    graph = tf.Graph()
    with graph.as_default():
        inp = tf1.placeholder(tf.float32, x.shape)
        logits_t = e2e._tf_model(inp, (3, 4, 6, 3), 7, assembled=assembled, bl=bl)
        ema_op = tf1.train.ExponentialMovingAverage(0.99).apply(tf1.trainable_variables())
        saver = tf1.train.Saver()
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            e2e._randomize_variables(sess, rng)
            sess.run(ema_op)
            sess.run([v.assign(v * 1.05) for v in tf1.trainable_variables()])
            logits_tf = sess.run(logits_t, {inp: x})
            tf_vals = {v.name.split(":")[0]: sess.run(v) for v in tf1.global_variables()}
            ckpt = saver.save(sess, str(tmp_path / "tfckpt" / "model.ckpt"))

    model = ResNet(cfg).eval()
    logits = {}
    for use_ema in (False, True):
        state_dict, missing = t_tf_import.import_tf_checkpoint(ckpt, cfg, model.state_dict(),
                                                               use_ema=use_ema)
        assert not missing
        model.load_state_dict(state_dict)
        with torch.inference_mode():
            logits[use_ema] = model(torch.from_numpy(x)).numpy()
    for tf_name, key, _ in t_tf_import.expected_tf_names(cfg):
        got = model.state_dict()[key].numpy()
        want = tf_vals[tf_name + (j_tf_import.EMA_SUFFIX if tf_name + j_tf_import.EMA_SUFFIX
                                  in tf_vals else "")]
        np.testing.assert_array_equal(got, _to_torch_layout(want), err_msg=tf_name)
    scale = float(np.abs(logits_tf).max())
    assert np.abs(logits[False] - logits_tf).max() < max(5e-4, 0.02 * scale)
    assert np.abs(logits[True] - logits[False]).max() > 0.01 * scale
