"""The port's jax-free copy of the config tree equals the reference, and
the port never imports jax."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

from multipathnet_tpu.core import config as jcfg
from multipathnet_tpu_torch.core import config as tcfg

ROOT = Path(__file__).resolve().parents[1]


# presets the port has and the reference lacks: name -> (the reference's
# preset it derives from, the model fields it changes)
PORT_ONLY = {"multipath_resnet101_int8_svd":
             ("multipath_vgg16_int8_svd", {"backbone": "resnet101"}),
             "multipath_resnet101_train":
             ("multipath_vgg16_train", {"backbone": "resnet101"})}


def test_preset_names_match_reference():
    assert tcfg.PRESETS == jcfg.PRESETS + tuple(PORT_ONLY)


@pytest.mark.parametrize("name", sorted(PORT_ONLY))
def test_port_only_preset_derives_from_reference(name):
    base, model = PORT_ONLY[name]
    want = jcfg.preset(base)
    want = dataclasses.replace(
        want, name=name, model=dataclasses.replace(want.model, **model))
    assert (dataclasses.asdict(tcfg.preset(name))
            == dataclasses.asdict(want))


@pytest.mark.parametrize("name", jcfg.PRESETS)
def test_preset_matches_reference(name):
    assert (dataclasses.asdict(tcfg.preset(name))
            == dataclasses.asdict(jcfg.preset(name)))
    assert tcfg.preset(name).to_json() == jcfg.preset(name).to_json()


def test_config_json_roundtrip_and_unknown_preset():
    c = tcfg.preset("tiny")
    assert tcfg.Config.from_json(c.to_json()) == c
    with pytest.raises(KeyError):
        tcfg.preset("nope")


_CHECK = """
import importlib, pkgutil, sys
import multipathnet_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import importlib.util
for name, path in (("chip_smoke", "chip_smoke.py"),
                   ("torch_mesh_workers", "tests/torch_mesh_workers.py")):
    spec = importlib.util.spec_from_file_location(name, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "multipathnet_tpu"))
print("LEAKED", bad)
print("IMPORTED", sorted(m for m in sys.modules
                         if m.startswith("multipathnet_tpu_torch.")))
sys.exit(1 if bad else 0)
"""

# modules the subprocess must have imported: the training, serving and
# dataset-to-AP paths' included
_MUST_IMPORT = ("ops.roi_pool", "ops._build", "ops.quant", "ops.lowrank",
                "tools.probe_int8_window_dma",
                "core.device", "models.layers", "models.heads",
                "models.convert", "models.multipath", "data.sampler",
                "train.losses", "train.schedule", "train.loop",
                "eval.detect", "eval.serving", "core.padding", "data.rle",
                "data.proposals", "data.coco", "data.voc", "data.synthetic",
                "data.pipeline", "eval.coco_eval", "eval.voc_eval",
                "eval.tester", "train.checkpoint", "utils.metrics",
                "cli.common", "cli.eval", "cli.train", "data.t7",
                "models.backbones.resnet", "models.import_weights",
                "models.t7_import", "ops.roi", "ops.roi_pyramid",
                "ops.scatter", "models.sharpmask", "train.proposal",
                "cli.export_proposals", "cli.demo", "cli.export_serving",
                "cli.serve", "core.mesh", "tools.mesh_runs",
                "utils.tbevents", "utils.profiling", "data.rle_native",
                "tools.soak_svd_decay", "tools.prop_quality_scale",
                "bench")


def test_port_never_imports_jax():
    """Every module of the port, chip_smoke.py and the mesh tests' rank
    bodies (tests/torch_mesh_workers.py; spawned ranks import their
    function's module) import without jax (nor flax or optax)."""
    proc = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    imported = proc.stdout.split("IMPORTED", 1)[1]
    for name in _MUST_IMPORT:
        assert f"'multipathnet_tpu_torch.{name}'" in imported, name


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """Without a CUDA device chip_smoke.py exits non-zero and prints no
    result line; alone in a directory it fails too."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((ROOT, "chip_smoke.py"),
                        (tmp_path, str(tmp_path / "chip_smoke.py"))):
        if cwd == tmp_path:
            (tmp_path / "chip_smoke.py").write_text(
                (ROOT / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, script], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
