"""The port's CLIs and checkpoints on the CPU: config overrides against the
JAX package's, the train CLI (config dump, JSONL metrics, checkpoints,
--resume), the eval CLI (float, int8 and truncated-SVD serving presets on a
float checkpoint) and Checkpointer (exact resume, max_to_keep, idempotent
saves). Everything runs at `tiny` with --device cpu on a synthetic split in
a temp dir."""

import dataclasses
import json
import os

import pytest
import torch

from multipathnet_tpu.cli import common as jcommon
from multipathnet_tpu.core.config import preset as jpreset
from multipathnet_tpu_torch.cli import common
from multipathnet_tpu_torch.cli import eval as eval_cli
from multipathnet_tpu_torch.cli import train as train_cli
from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.eval.detect import Detector
from multipathnet_tpu_torch.eval.tester import Tester
from multipathnet_tpu_torch.train.checkpoint import Checkpointer
from multipathnet_tpu_torch.train.loop import Trainer

torch.set_num_threads(2)

OVERRIDES = [
    [],
    ["train.lr=0.5", "model.foveal_scales=1.0,2.0", "data.image_size=32,32"],
    ["model.head_quant=int8", "model.fc6_rank=16", "eval.score_threshold=0"],
    ["train.lr_decay_steps=(10,20)", "data.bg_iou_range=0.0,0.4",
     "model.class_specific_bbox=false", "model.skip_levels=c4,c5"],
    ["train.batch_size=4", "model.backbone=vgg16", "name=x"],
]
BAD = [["bogus.field=1"], ["train.lr"], ["train.nope=3"], ["model=1"]]


@pytest.mark.parametrize("pairs", OVERRIDES)
@pytest.mark.parametrize("name", ["tiny", "multipath_vgg16_train"])
def test_apply_overrides_matches_reference(name, pairs):
    try:
        want = jcommon.apply_overrides(jpreset(name), pairs).to_json()
    except (SystemExit, AttributeError, TypeError) as e:
        with pytest.raises(type(e)) as got:
            common.apply_overrides(preset(name), pairs)
        assert str(got.value) == str(e)
        return
    assert common.apply_overrides(preset(name), pairs).to_json() == want


@pytest.mark.parametrize("pairs", BAD)
def test_bad_overrides_exit_as_reference(pairs):
    with pytest.raises(SystemExit) as want:
        jcommon.apply_overrides(jpreset("tiny"), pairs)
    with pytest.raises(SystemExit) as got:
        common.apply_overrides(preset("tiny"), pairs)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def run1(tmp_path_factory):
    """A 6-step `tiny` run on a synthetic split, checkpoints every 3."""
    work = tmp_path_factory.mktemp("cli")
    ckpt_dir = str(work / "run1")
    train_cli.main([
        "--preset", "tiny", "--synthetic", "--device", "cpu",
        "--dataset-root", str(work / "ds"), "--steps", "6",
        "--set", f"train.checkpoint_dir={ckpt_dir}",
        "--set", "train.checkpoint_every=3", "--set", "train.log_every=2"])
    return work, ckpt_dir


def test_train_cli_writes_config_metrics_and_checkpoints(run1):
    _, ckpt_dir = run1
    cfg = json.load(open(os.path.join(ckpt_dir, "config.json")))
    assert cfg["model"]["num_classes"] == 5   # 4 synthetic classes + bg
    rows = [json.loads(line) for line in
            open(os.path.join(ckpt_dir, "metrics.jsonl"))]
    assert [r["step"] for r in rows if "loss" in r] == [2, 4, 6]
    assert all(r["lr"] == 0.02 for r in rows if "loss" in r)
    final = [r for r in rows if r.get("tag") == "final"]
    assert len(final) == 1 and "AP50" in final[0]
    ck = Checkpointer(os.path.join(ckpt_dir, "ckpt"))
    assert ck.all_steps() == [3, 6]


def test_train_cli_resume_continues(run1, tmp_path):
    """--resume from a copy of run1's checkpoints continues at step 6 and
    checkpoints 9."""
    import shutil

    work, ckpt_dir = run1
    resumed = str(tmp_path / "resumed")
    shutil.copytree(ckpt_dir, resumed)
    train_cli.main([
        "--preset", "tiny", "--synthetic", "--device", "cpu",
        "--dataset-root", str(work / "ds"), "--steps", "9", "--resume",
        "--no-final-eval", "--set", f"train.checkpoint_dir={resumed}",
        "--set", "train.checkpoint_every=3"])
    assert Checkpointer(os.path.join(resumed, "ckpt")).all_steps() == [3, 6,
                                                                       9]
    rows = [json.loads(line) for line in
            open(os.path.join(resumed, "metrics.jsonl"))]
    assert rows[-1]["step"] == 7 and "time_to_first_step" in rows[-1]


def test_train_cli_refuses_a_used_checkpoint_dir(run1, tmp_path):
    """A fresh run (no --resume) into a directory that holds checkpoints
    exits before it writes anything, rather than training and skipping the
    saves of steps already there."""
    import shutil

    work, ckpt_dir = run1
    used = str(tmp_path / "used")
    shutil.copytree(ckpt_dir, used)
    before = {n: os.path.getmtime(os.path.join(used, n))
              for n in os.listdir(used)}
    with pytest.raises(SystemExit, match="--resume"):
        train_cli.main([
            "--preset", "tiny", "--synthetic", "--device", "cpu",
            "--dataset-root", str(work / "ds"), "--steps", "6",
            "--set", f"train.checkpoint_dir={used}"])
    assert {n: os.path.getmtime(os.path.join(used, n))
            for n in os.listdir(used)} == before
    assert Checkpointer(os.path.join(used, "ckpt")).all_steps() == [3, 6]


@pytest.mark.parametrize("flag", ["--tensorboard"])
def test_train_cli_unported_modes_raise(flag, tmp_path):
    """The modes that once raised as not ported now run. --tensorboard:
    2 steps logged at every step write <checkpoint_dir>/tb, and its
    scalars read back, through the port's read_scalars and the JAX
    package's alike, equal to the JSONL metrics rows (float32 values)."""
    import numpy as np

    from multipathnet_tpu.utils import tbevents as jtb
    from multipathnet_tpu_torch.utils import tbevents

    run = tmp_path / "run"
    train_cli.main([
        "--preset", "tiny", "--synthetic", "--device", "cpu",
        "--dataset-root", str(tmp_path / "ds"), "--steps", "2", flag,
        "--no-final-eval", "--set", f"train.checkpoint_dir={run}",
        "--set", "train.log_every=1"])
    files = os.listdir(run / "tb")
    assert len(files) == 1 and "tfevents" in files[0]
    path = str(run / "tb" / files[0])
    seen = tbevents.read_scalars(path)
    assert seen == jtb.read_scalars(path)
    rows = [json.loads(line) for line in open(run / "metrics.jsonl")]
    logged = [r for r in rows if "loss" in r]
    assert [r["step"] for r in logged] == [1, 2]
    for r in logged:
        for k in ("loss", "lr", "grad_norm"):
            assert abs(seen[k][r["step"]] - np.float32(r[k])) <= 1e-6 * max(
                1.0, abs(r[k])), (k, r)
    assert set(seen["time_to_first_step"]) == {1}


# ------------------------------------------- config 5: the proposal net ---

@pytest.fixture(scope="module")
def proposal_run(run1):
    """`cli.train --proposal-net`: 4 steps at lr 5e-3 on run1's split,
    checkpoints every 2, the final proposal-recall eval."""
    work, _ = run1
    ckpt_dir = str(work / "prop")
    train_cli.main([
        "--preset", "tiny", "--synthetic", "--device", "cpu",
        "--dataset-root", str(work / "ds"), "--steps", "4", "--proposal-net",
        "--set", f"train.checkpoint_dir={ckpt_dir}", "--set", "train.lr=0.005",
        "--set", "train.checkpoint_every=2", "--set", "train.log_every=2"])
    return work, ckpt_dir


def test_train_cli_proposal_net(proposal_run):
    """--proposal-net trains the SharpMask network: losses logged, its
    checkpoints at 2 and 4, and the final eval is proposal recall, not
    AP."""
    _, ckpt_dir = proposal_run
    rows = [json.loads(line) for line in
            open(os.path.join(ckpt_dir, "metrics.jsonl"))]
    logged = [r for r in rows if "loss" in r]
    assert [r["step"] for r in logged] == [2, 4]
    assert all("loss_mask" in r and "loss_ref_obj" in r for r in logged)
    final = [r for r in rows if r.get("tag") == "final"]
    assert len(final) == 1 and "AP50" not in final[0]
    assert 0.0 <= final[0]["proposal_recall@0.5"] <= 1.0
    assert final[0]["top_k"] == 64.0
    assert Checkpointer(os.path.join(ckpt_dir, "ckpt")).all_steps() == [2, 4]


def test_export_proposals_read_by_both_packages(proposal_run, tmp_path,
                                                capsys):
    """cli.export_proposals --with-masks on the trained net: the .npz reads
    the same in the JAX package's ProposalStore and the port's (boxes,
    scores, ids, RLE masks), its boxes are generate_proposals' on the
    restored net, and cli.eval runs the detector on it."""
    import numpy as np

    from multipathnet_tpu.data.proposals import ProposalStore as JStore
    from multipathnet_tpu_torch.cli import export_proposals
    from multipathnet_tpu_torch.data.coco import CocoLoader
    from multipathnet_tpu_torch.data.proposals import ProposalStore
    from multipathnet_tpu_torch.data.transforms import normalize
    from multipathnet_tpu_torch.models.sharpmask import generate_proposals

    work, ckpt_dir = proposal_run
    out = str(tmp_path / "generated.npz")
    export_proposals.main([
        "--preset", "tiny", "--synthetic", "--device", "cpu",
        "--dataset-root", str(work / "ds"), "--proposal-checkpoint-dir",
        ckpt_dir, "--output", out, "--top-k", "8", "--batch-size", "3",
        "--with-masks"])
    got, ref = ProposalStore.load(out), JStore.load(out)
    loader = CocoLoader(str(work / "ds" / "annotations" /
                            "instances_synthetic.json"),
                        str(work / "ds" / "synthetic"))
    assert len(got) == len(ref) == len(loader) == 16
    for i in range(len(loader)):
        iid = loader.image_id(i)
        (b, s), (jb, js) = got.for_image_id(iid), ref.for_image_id(iid)
        np.testing.assert_array_equal(b, jb)
        np.testing.assert_array_equal(s, js)
        assert b.shape == (8, 4)
        assert got.rles_for_image_id(iid) == ref.rles_for_image_id(iid)
    trainer, state = common.restore_proposal_state(
        preset("tiny"), ckpt_dir, device="cpu")
    assert state.step == 4
    want = generate_proposals(trainer.model, normalize(torch.from_numpy(
        np.array(loader.load_image(5))))[None], top_k=8, with_masks=False)
    np.testing.assert_array_equal(got.for_image_id(loader.image_id(5))[0],
                                  want["boxes"][0].numpy())
    eval_cli.main(["--preset", "tiny", "--synthetic", "--device", "cpu",
                   "--dataset-root", str(work / "ds"), "--proposals", out,
                   "--json"])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"AP", "AP50"} <= set(metrics)


def test_export_proposals_refuses_mixed_image_sizes(monkeypatch, tmp_path):
    """Images go through at their own size: a split with two sizes exits
    before any proposal is written."""
    from multipathnet_tpu_torch.cli import export_proposals

    class Mixed:
        def __len__(self):
            return 2

        def image_size(self, i):
            return (64, 64) if i == 0 else (48, 64)

    monkeypatch.setattr(common, "resolve_data", lambda args, cfg: (Mixed(),
                                                                   None))
    out = tmp_path / "p.npz"
    with pytest.raises(SystemExit, match="uniform image sizes"):
        export_proposals.main(["--preset", "tiny", "--device", "cpu",
                               "--output", str(out)])
    assert not out.exists()


@pytest.mark.parametrize("source", ["file", "sharpmask", "sliding"])
def test_demo_cli_writes_a_png(run1, proposal_run, source, tmp_path,
                               capsys):
    """cli.demo from each proposal source, on run1's detector (and the
    proposal run's net for sharpmask): a PNG of the image's size."""
    from PIL import Image

    from multipathnet_tpu_torch.cli import demo

    work, det_dir = run1
    _, prop_dir = proposal_run
    out = str(tmp_path / f"{source}.png")
    demo.main(["--preset", "tiny", "--synthetic", "--device", "cpu",
               "--dataset-root", str(work / "ds"), "--checkpoint-dir",
               det_dir, "--index", "3", "--proposal-source", source,
               "--proposal-checkpoint-dir", prop_dir, "--top-proposals",
               "16", "--score-threshold", "0", "--output", out])
    printed = capsys.readouterr().out
    assert f"wrote {out}" in printed
    assert ("sharpmask: 16 proposals" in printed) == (source == "sharpmask")
    img = Image.open(out)
    assert img.size == (64, 64) and img.mode == "RGB"


def test_sliding_window_proposals_match_reference():
    import numpy as np

    from multipathnet_tpu.cli import demo as jdemo
    from multipathnet_tpu_torch.cli import demo

    for h, w, n in ((64, 64, 256), (480, 640, 100), (30, 90, 7)):
        np.testing.assert_array_equal(demo.sliding_window_proposals(h, w, n),
                                      jdemo.sliding_window_proposals(h, w, n))


def test_export_serving_then_serve(run1, tmp_path):
    """cli.export_serving --quant int8 of run1's checkpoint, then a
    DetectionService on the bundle: its detections equal an int8 Detector
    built in process from the same checkpoint."""
    import numpy as np

    from multipathnet_tpu_torch.cli import export_serving
    from multipathnet_tpu_torch.cli.serve import DetectionService

    work, ckpt_dir = run1
    bundle = str(tmp_path / "bundle")
    export_serving.main(["--preset", "tiny", "--device", "cpu",
                         "--checkpoint-dir", ckpt_dir, "--out", bundle,
                         "--set", "model.num_classes=5"])
    assert sorted(os.listdir(bundle)) == ["config.json", "params.pt"]
    svc = DetectionService(bundle, device="cpu")
    assert svc.cfg.model.head_quant == "int8"
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 255, (64, 64, 3)).astype(np.uint8)
              for _ in range(3)]
    props = [[[2.0, 2.0, 30.0, 30.0], [10.0, 8.0, 44.0, 40.0],
              [20.0, 20.0, 60.0, 50.0]]] * 3
    got = svc(images, props)
    cfg = svc.cfg
    trainer, _ = common.restore_float_state(
        cfg.replace(model=dataclasses.replace(cfg.model, head_quant="none")),
        ckpt_dir, device="cpu")
    model, tree = common.eval_model_for(cfg, trainer)
    assert tree is not None
    det = Detector(model, cfg, params=tree)
    p = cfg.data.max_proposals
    for i in range(3):
        pb = np.zeros((1, p, 4), np.float32)
        pb[0, :3] = props[i]
        out = det(images[i][None], np.asarray([[64, 64]], np.float32), pb,
                  (np.arange(p) < 3)[None])
        valid = out["valid"][0]
        assert got[i]["boxes"] == out["boxes"][0][valid].round(2).tolist()
        assert got[i]["scores"] == out["scores"][0][valid].round(4).tolist()
        assert got[i]["classes"] == out["classes"][0][valid].tolist()


def test_checkpoint_resume_is_bit_exact_for_the_proposal_net(run1,
                                                              tmp_path):
    """ProposalTrainer through Checkpointer: two steps, save, restore into
    a fresh ProposalTrainer, one step — against three straight: loss,
    every parameter, the momentum and the generator equal bit for bit."""
    from multipathnet_tpu_torch.data.coco import CocoLoader
    from multipathnet_tpu_torch.data.pipeline import DetectionPipeline
    from multipathnet_tpu_torch.data.proposals import ProposalStore
    from multipathnet_tpu_torch.train.proposal import ProposalTrainer

    work, _ = run1
    ds = work / "ds"
    cfg = preset("tiny")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, lr=5e-3))
    pipe = DetectionPipeline(
        CocoLoader(str(ds / "annotations" / "instances_synthetic.json"),
                   str(ds / "synthetic")),
        ProposalStore.load(str(ds / "proposals_synthetic.npz")), cfg.data,
        batch_size=2, with_masks=True)
    batches = list(pipe.epoch(0))[:3]
    straight = ProposalTrainer(cfg, device="cpu")
    state = straight.init_state(0)
    ckpt = Checkpointer(str(tmp_path / "ck"))
    for b in batches[:2]:
        state, _ = straight.step(state, b)
    ckpt.save(straight, state)
    state, want = straight.step(state, batches[2])
    resumed = ProposalTrainer(cfg, device="cpu")
    restored = ckpt.restore_latest(resumed, resumed.init_state(1))
    assert restored.step == 2 and restored.optimizer.count == 2
    restored, got = resumed.step(restored, batches[2])
    assert torch.equal(got["loss"], want["loss"])
    pa = dict(straight.model.named_parameters())
    for n, p in resumed.model.named_parameters():
        assert torch.equal(p, pa[n]), n
    sa = state.optimizer.sgd.state_dict()["state"]
    sb = restored.optimizer.sgd.state_dict()["state"]
    for k in sa:
        assert torch.equal(sa[k]["momentum_buffer"],
                           sb[k]["momentum_buffer"])
    assert torch.equal(state.generator.get_state(),
                       restored.generator.get_state())


def _eval_json(capsys, run1, *extra):
    work, ckpt_dir = run1
    eval_cli.main(["--preset", "tiny", "--synthetic", "--device", "cpu",
                   "--dataset-root", str(work / "ds"),
                   "--checkpoint-dir", ckpt_dir, "--json", *extra])
    out = capsys.readouterr()
    return json.loads(out.out.strip().splitlines()[-1]), out.err


def test_eval_cli_matches_in_process_tester(run1, capsys):
    """The eval CLI's metrics equal a Tester's on the restored parameters
    (and the train CLI's final eval, at the same step)."""
    work, ckpt_dir = run1
    metrics, _ = _eval_json(capsys, run1)
    args = eval_cli.argparse.Namespace(
        dataset="coco", synthetic=True, dataset_root=str(work / "ds"),
        split="synthetic", proposals="", annotations="")
    cfg = preset("tiny")
    loader, props = common.resolve_data(args, cfg)
    trainer, state = common.restore_float_state(cfg, ckpt_dir, device="cpu")
    assert state.step == 6
    want = Tester(trainer.model, cfg, loader, props, device="cpu").test()
    assert metrics == {k: round(v, 5) for k, v in want.items()}
    final = [json.loads(line) for line in
             open(os.path.join(ckpt_dir, "metrics.jsonl"))][-1]
    assert final["AP50"] == round(want["AP50"], 6)


def test_eval_cli_int8_serving_config(run1, capsys):
    """head_quant=int8 restores the FLOAT checkpoint and quantizes at load
    (as tests/test_cli.py holds the reference to); AP stays within
    quantization noise of the float eval."""
    results = {hq: _eval_json(capsys, run1, "--set", f"model.head_quant={hq}")
               for hq in ("none", "int8")}
    assert abs(results["int8"][0]["AP50"]
               - results["none"][0]["AP50"]) <= 0.1
    assert "serving transforms (head_quant=int8)" in results["int8"][1]


@pytest.mark.filterwarnings("ignore:truncated-SVD rank is too aggressive")
def test_eval_model_for_factorizes_a_ranked_config(run1):
    """A ranked config evaluates a factored model built for it, not the
    full-rank float model the checkpoint restores into."""
    _, ckpt_dir = run1
    cfg = preset("tiny")
    ranked = cfg.replace(model=dataclasses.replace(cfg.model, fc6_rank=16,
                                                   fc7_rank=8))
    trainer, _ = common.restore_float_state(ranked, ckpt_dir, device="cpu")
    assert trainer.cfg.model.fc6_rank == 0
    model, params = common.eval_model_for(ranked, trainer)
    assert model is not trainer.model and hasattr(model.head, "fc6_f0_u")
    Detector(model, ranked, "cpu", params=params)   # factorizes at load
    assert model.head.fc6_f0_u.weight.shape[0] == 16
    assert common.eval_model_for(cfg, trainer) == (trainer.model, None)
    with pytest.raises(SystemExit, match="no checkpoint"):
        common.restore_float_state(cfg, str(ckpt_dir) + "_missing",
                                   device="cpu")


def _batches(n, root):
    """n `tiny` batches of 2 from a synthetic split, through the
    pipeline."""
    from multipathnet_tpu_torch.data import synthetic
    from multipathnet_tpu_torch.data.coco import CocoLoader
    from multipathnet_tpu_torch.data.pipeline import DetectionPipeline
    from multipathnet_tpu_torch.data.proposals import ProposalStore

    fx = synthetic.generate(str(root), num_images=2 * n, image_size=64,
                            proposals_per_image=24, seed=1)
    pipe = DetectionPipeline(CocoLoader(fx["annotations"], fx["images"]),
                             ProposalStore.load(fx["proposals"]),
                             preset("tiny").data, batch_size=2)
    return list(pipe.epoch(0))


def test_checkpoint_resume_is_bit_exact(tmp_path):
    """Two steps, save, restore into a fresh Trainer, one step — against
    three steps straight: loss, every parameter, the momentum and the
    generator's state equal bit for bit."""
    cfg = preset("tiny")
    batches = _batches(3, tmp_path / "ds")
    straight = Trainer(cfg, device="cpu")
    state = straight.init_state(0)
    ckpt = Checkpointer(str(tmp_path / "ck"))
    for b in batches[:2]:
        state, _ = straight.step(state, b)
    ckpt.save(straight, state)
    state, want = straight.step(state, batches[2])

    resumed = Trainer(cfg, device="cpu")
    template = resumed.init_state(1)          # other weights and generator
    restored = ckpt.restore_latest(resumed, template)
    assert restored.step == 2 and restored.optimizer.count == 2
    restored, got = resumed.step(restored, batches[2])
    assert restored.step == state.step == 3
    assert torch.equal(got["loss"], want["loss"])
    pa = dict(straight.model.named_parameters())
    for n, p in resumed.model.named_parameters():
        assert torch.equal(p, pa[n]), n
    sa = state.optimizer.sgd.state_dict()["state"]
    sb = restored.optimizer.sgd.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k]["momentum_buffer"],
                           sb[k]["momentum_buffer"])
    assert torch.equal(state.generator.get_state(),
                       restored.generator.get_state())


def test_checkpointer_keeps_latest_and_skips_saved_steps(tmp_path):
    """max_to_keep prunes the oldest; a step already saved is not written
    again; no temporary file is left behind; an empty directory restores
    nothing."""
    cfg = preset("tiny")
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0)
    ckpt = Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
    assert ckpt.latest_step() is None
    assert ckpt.restore_latest(trainer, state) is None
    for b in _batches(3, tmp_path / "ds"):
        state, _ = trainer.step(state, b)
        ckpt.save(trainer, state)
    ckpt.wait()
    assert ckpt.all_steps() == [2, 3] and ckpt.latest_step() == 3
    path = os.path.join(ckpt.directory, "step_3.pt")
    before = os.stat(path).st_mtime_ns
    ckpt.save(trainer, state)
    ckpt.wait()
    assert os.stat(path).st_mtime_ns == before
    assert sorted(os.listdir(ckpt.directory)) == ["step_2.pt", "step_3.pt"]
    saved = torch.load(path, weights_only=True)
    assert saved["step"] == 3 and saved["count"] == 3
    assert all(t.dtype == torch.float32 for t in saved["params"].values())
    assert set(saved["params"]) == {n for n, _ in
                                    trainer.model.named_parameters()}
