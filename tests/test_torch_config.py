"""The port's config system and presets against the reference's, and the
port's isolation from JAX.

``axcnn_torch.utils.config`` keeps its own copy of the four config
dataclasses (``axcnn/utils/config.py`` pulls in JAX through ``ModelConfig``);
these tests keep the copy from drifting: same fields, same defaults, same
presets, same CLI grammar.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from axcnn.core import dtypes as jdtypes
from axcnn.utils import config as jconfig
from axcnn_torch.core import dtypes as tdtypes
from axcnn_torch.utils import config as tconfig

REPO = Path(__file__).resolve().parent.parent
SECTIONS = ("model", "data", "train", "runtime")


def _fields(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING
             else f.default_factory()) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("section", SECTIONS)
def test_fields_and_defaults_match_reference(section):
    jcls = type(getattr(jconfig.Config(), section))
    tcls = type(getattr(tconfig.Config(), section))
    assert _fields(tcls) == _fields(jcls)


@pytest.mark.parametrize("preset", ["assemble_resnet50", "vanilla_resnet50", "finetune_fgvc",
                                    "assemble_resnet152_kd", "bl_resnet50"])
def test_presets_match_reference(preset):
    assert tconfig.load_preset(preset).to_dict() == jconfig.load_preset(preset).to_dict()


@pytest.mark.parametrize("argv", [
    ["--config=assemble_resnet50", "--train.dtype=fp32", "--model.width_multiplier=0.5"],
    ["--use_se_block", "--anti_alias_type=proj", "--dropblock_stages=2,3,4"],
    ["--config=vanilla_resnet50", "--data.preprocessing_type=imagenet_224_256a",
     "--runtime.eval_only=true", "--batch_size=64"],
])
def test_cli_grammar_matches_reference(argv):
    assert tconfig.parse_cli(argv).to_dict() == jconfig.parse_cli(argv).to_dict()


@pytest.mark.parametrize("argv,match", [
    (["--model.nope=1"], "unknown config field"),
    (["--nope=1"], "unknown config field"),
    (["--model.zero_gamma=maybe"], "bad bool"),
    (["train.dtype=fp32"], "must start with --"),
    (["--model.anti_alias_type=blur"], "bad anti_alias_type"),
    (["--model.bl_alpha=2"], "set together"),
])
def test_cli_errors_match_reference(argv, match):
    for parse in (tconfig.parse_cli, jconfig.parse_cli):
        with pytest.raises(ValueError, match=match):
            parse(argv)


def test_unknown_preset_names_the_presets():
    with pytest.raises(ValueError, match="unknown preset 'nope'.*assemble_resnet152_kd"):
        tconfig.parse_cli(["--config=nope"])


def test_dtype_policies_match_reference():
    jmap = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    for name in ("fp32", "float32", "bf16", "bfloat16", "fp16", "float16", "amp", "int8",
                 "INT8"):
        j, t = jdtypes.policy_from_name(name), tdtypes.policy_from_name(name)
        assert jmap[j.compute_dtype] == t.compute_dtype
        assert jmap[j.param_dtype] == t.param_dtype
        assert j.quantize_conv == t.quantize_conv == (name.lower() == "int8")
    with pytest.raises(ValueError, match="unknown dtype policy"):
        tdtypes.policy_from_name("fp8")


# the training slice's modules, named so that the walk below must reach them
TRAINING_MODULES = [
    "axcnn_torch.ckpt.checkpoint", "axcnn_torch.cli.main_classification",
    "axcnn_torch.core.rng",
    "axcnn_torch.data.mixup", "axcnn_torch.kernels.dropblock",
    "axcnn_torch.ops.dropblock", "axcnn_torch.train.ema", "axcnn_torch.train.loop",
    "axcnn_torch.train.losses", "axcnn_torch.train.optimizer",
    "axcnn_torch.train.schedules"]


def test_port_imports_no_jax():
    """Every module of axcnn_torch imports without pulling in jax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import axcnn_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(axcnn_torch.__path__, 'axcnn_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        f"assert set({TRAINING_MODULES!r}) <= set(mods), mods\n"
        "assert len(mods) >= 30, mods\n"
        "assert 'jax' not in sys.modules, [m for m in sys.modules if 'jax' in m]\n"
        "print('ok', len(mods))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_kernel_module_imports_without_nvcc(monkeypatch):
    """Importing the kernel wrapper builds nothing; the build asks for nvcc
    only when a kernel is first launched, and says so when it is missing."""
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.path.dirname(sys.executable)
    proc = subprocess.run(
        [sys.executable, "-c", "import axcnn_torch.kernels.blurpool as k; "
         "import axcnn_torch.kernels.dropblock as d; "
         "from axcnn_torch.kernels import build; "
         "assert k.LAUNCHES == k.BWD_LAUNCHES == d.LAUNCHES == 0; "
         "assert build._lib is None"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

    import torch.utils.cpp_extension as cpp_ext
    from axcnn_torch.kernels import build

    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()


def test_library_path_is_keyed_on_the_sources():
    from axcnn_torch.kernels import build

    so = build.library_path()
    assert so.parent == build.BUILD_DIR and so.suffix == ".so"
    assert so == build.library_path()  # stable for unchanged sources
    for src in ("blurpool.cu", "dropblock.cu"):
        assert (REPO / "axcnn_torch" / "csrc" / src).exists()
