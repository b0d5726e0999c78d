"""How the `tiny` overfit check's outcome spreads over init seeds, for the
port and for the JAX package, and whether the port's run is the
reference's from the same weights. The setup is the reference's
overfit_tiny fixture (tests/conftest.py; 8 synthetic images of 64^2, seed 5,
`tiny` with 5 classes, batch 2, DetectionPipeline(seed=0), 30 epochs), one
run per init seed, on the CPU. Prints one line per seed: AP50 before and
after, the first and last loss. tests/test_torch_eval.py and chip_smoke.py
phase 14 hold the median of seeds 0-4 to the reference's bar because of this
spread.

    python tests/overfit_seeds.py port 0 18
    python tests/overfit_seeds.py reference 0 12 [--pallas]

The reference's Trainer pins its "direct" roi_align route off the TPU, a
different pooling from the window pool the port mirrors; `--pallas` trains
it through its TPU route instead (the Pallas kernels in interpret mode,
about ten times slower).

`--init port|reference` draws each seed's starting weights with the other
package's initializer and carries them across (models/convert.py); the
trainer's own random stream (flips, ROI sampling, dropout) still comes
from the seed:

    python tests/overfit_seeds.py reference 0 6 --init port
    python tests/overfit_seeds.py port 0 6 --init reference

`lockstep` trains the port from its own init and, step for step on the
same batches, the reference's train step (its Pallas route) from the same
weights with the port's random draws injected: each step's flips, ROI
sample and dropout masks. It prints both mean losses per epoch, both AP50s
and the largest parameter difference at the end. Where the two runs agree,
an outcome of the port's run (a stall included) is what the reference's
step makes of the same weights and draws; `--dtype float32` takes bf16
rounding out of the comparison:

    python tests/overfit_seeds.py lockstep 0 3 [--dtype float32]

tests/test_torch_train.py runs the first steps of `lockstep` as a test.
"""

import argparse
import dataclasses
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _config(preset, dtype=None, route=None):
    """The fixture's config: `tiny` with 5 classes; `dtype` the model's
    compute dtype (default the preset's, bfloat16); `route` the reference's
    ROI route (roi_impl and train_roi_impl)."""
    cfg = preset("tiny")
    model = dict(num_classes=5, dtype=dtype or cfg.model.dtype)
    if route:
        model.update(roi_impl=route, train_roi_impl=route)
    return cfg.replace(model=dataclasses.replace(cfg.model, **model))


def fixture(root):
    """The overfit_tiny fixture's split, written under `root`."""
    from multipathnet_tpu_torch.data import synthetic

    return synthetic.generate(root, num_images=8, image_size=64,
                              num_classes=4, proposals_per_image=24, seed=5)


def _port_init(seeds, dtype=None):
    """seed -> the port's initial weights as a flax tree (numpy)."""
    from multipathnet_tpu_torch.core.config import preset
    from multipathnet_tpu_torch.models import convert
    from multipathnet_tpu_torch.train.loop import Trainer

    trainer = Trainer(_config(preset, dtype), device="cpu")
    for seed in seeds:
        trainer.init_state(seed)
        yield convert.flax_from_state_dict(trainer.model.state_dict())


def _reference_init(seeds, dtype=None):
    """seed -> the JAX package's initial weights as a flax tree (numpy)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from multipathnet_tpu.core.config import preset
    from multipathnet_tpu.train.loop import Trainer

    trainer = Trainer(_config(preset, dtype))
    for seed in seeds:
        yield jax.device_get(trainer.init_state(seed).params)


def _port(fx, seeds, init, dtype=None, pallas=False):
    import torch

    from multipathnet_tpu_torch.core.config import preset
    from multipathnet_tpu_torch.data.coco import CocoLoader
    from multipathnet_tpu_torch.data.pipeline import DetectionPipeline
    from multipathnet_tpu_torch.data.proposals import ProposalStore
    from multipathnet_tpu_torch.eval.tester import Tester
    from multipathnet_tpu_torch.models import convert
    from multipathnet_tpu_torch.train.loop import Trainer

    torch.set_num_threads(2)
    cfg = _config(preset, dtype)
    loader = CocoLoader(fx["annotations"], fx["images"])
    props = ProposalStore.load(fx["proposals"])
    trainer = Trainer(cfg, device="cpu")
    pipe = DetectionPipeline(loader, props, cfg.data, batch_size=2, seed=0)
    inits = None if init is None else list(init(seeds, dtype))

    def ap50():
        return Tester(trainer.model, cfg, loader, props, device="cpu",
                      batch_size=2).test()["AP50"]

    for i, seed in enumerate(seeds):
        state = trainer.init_state(seed)
        if inits is not None:
            convert.load_flax_params(trainer.model, inits[i])
        before, losses = ap50(), []
        for ep in range(30):
            for batch in pipe.epoch_on_device(ep, trainer.stream_batch):
                state, m = trainer.step(state, batch)
                losses.append(float(m["loss"]))
        yield seed, before, ap50(), losses[0], losses[-1]


def _reference(fx, seeds, init, dtype=None, pallas=False):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from multipathnet_tpu.core.config import preset
    from multipathnet_tpu.data.coco import CocoLoader
    from multipathnet_tpu.data.pipeline import DetectionPipeline
    from multipathnet_tpu.data.proposals import ProposalStore
    from multipathnet_tpu.eval.tester import Tester
    from multipathnet_tpu.models.multipath import build_model
    from multipathnet_tpu.train.loop import Trainer, TrainState, \
        make_train_step

    cfg = _config(preset, dtype, "pallas" if pallas else None)
    loader = CocoLoader(fx["annotations"], fx["images"])
    props = ProposalStore.load(fx["proposals"])
    trainer = Trainer(cfg)
    model = trainer.model
    step = trainer.step
    if pallas:
        # the Trainer pins "direct" off the TPU: step the TPU route here
        model = build_model(cfg.model)
        step = jax.jit(make_train_step(model, cfg, trainer.tx))
    pipe = DetectionPipeline(loader, props, cfg.data, batch_size=2, seed=0)
    inits = None if init is None else list(init(seeds, dtype))

    def ap50(params):
        return Tester(model, params, cfg, loader, props,
                      batch_size=2).test()["AP50"]

    for i, seed in enumerate(seeds):
        state = trainer.init_state(seed)
        if inits is not None:
            params = jax.tree.map(jax.numpy.asarray, inits[i])
            state = trainer.shard_state(TrainState(
                state.step, params, trainer.tx.init(params), state.key))
        before, losses = ap50(state.params), []
        for ep in range(30):
            for batch in pipe.epoch(ep):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
        yield seed, before, ap50(state.params), losses[0], losses[-1]


def lockstep(fx, seeds, init=None, dtype=None, epochs=30, evaluate=True):
    """Per seed: the port's run from its init (or `init`'s weights) and the
    reference's step fed the same batches, weights and the port's draws.
    Yields dict(seed, losses=[(port, reference) per step], metrics=[(port
    dict, reference dict) per step], ap50=(port, reference) before and
    after when `evaluate`, drift=largest parameter difference at the
    end)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    jax.config.update("jax_platforms", "cpu")
    import flax.linen as fnn

    from multipathnet_tpu.core.config import preset as jpreset
    from multipathnet_tpu.data import sampler as jsampler
    from multipathnet_tpu.eval import tester as jtester
    from multipathnet_tpu.models.multipath import build_model as jbuild
    from multipathnet_tpu.train import loop as jloop
    from multipathnet_tpu.train import schedule as jschedule
    from multipathnet_tpu_torch.core.config import preset
    from multipathnet_tpu_torch.data.coco import CocoLoader
    from multipathnet_tpu_torch.data.pipeline import DetectionPipeline
    from multipathnet_tpu_torch.data.proposals import ProposalStore
    from multipathnet_tpu_torch.eval.tester import Tester
    from multipathnet_tpu_torch.models import convert
    from multipathnet_tpu_torch.models.heads import MultiPathHead
    from multipathnet_tpu_torch.train import loop as tloop

    torch.set_num_threads(2)
    # the reference's TPU route, its Pallas kernels in interpret mode: the
    # pooling the port mirrors
    cfg, jcfg = _config(preset, dtype), _config(jpreset, dtype, "pallas")
    loader = CocoLoader(fx["annotations"], fx["images"])
    props = ProposalStore.load(fx["proposals"])
    trainer = tloop.Trainer(cfg, device="cpu")
    jmodel = jbuild(jcfg.model)
    tx, _ = jschedule.make_optimizer(jcfg.train)
    pipe = DetectionPipeline(loader, props, cfg.data, batch_size=2, seed=0)
    inits = None if init is None else list(init(seeds, dtype))

    # the port's draws, recorded as its step makes them
    drawn = {}
    hflip, sample_batch = tloop._hflip_images, tloop.sampler_lib.sample_batch
    dropout = MultiPathHead._dropout

    def rec_hflip(images, widths, do_flip):
        drawn["flips"] = do_flip.numpy().copy()
        return hflip(images, widths, do_flip)

    def rec_sample(*a, **k):
        drawn["sample"] = out = sample_batch(*a, **k)
        return out

    def rec_dropout(self, h, train, generator):
        if train and self.dropout_rate:
            g = torch.Generator(h.device)
            g.set_state(generator.get_state())
            keep = 1.0 - self.dropout_rate
            drawn["masks"].append((torch.rand(h.shape, generator=g) < keep)
                                  .numpy())
        return dropout(self, h, train, generator)

    # the reference's step with those draws in place of its own
    ctx = {}
    bernoulli = jax.random.bernoulli
    jsample_batch, flax_dropout = jsampler.sample_batch, fnn.Dropout.__call__

    def drop(self, x, deterministic=None, rng=None):
        if self.deterministic if deterministic is None else deterministic:
            return x
        return jnp.where(ctx["masks"].pop(0), x / (1.0 - self.rate), 0)

    train_step = jloop.make_train_step(jmodel, jcfg, tx)

    @jax.jit
    def jstep(state, batch, flips, sample, masks):
        ctx.update(sample=sample, masks=list(masks))
        jax.random.bernoulli = lambda *a, **k: flips
        try:
            return train_step(state, batch)
        finally:
            jax.random.bernoulli = bernoulli

    def ap50s(state):
        port = Tester(trainer.model, cfg, loader, props, device="cpu",
                      batch_size=2).test()["AP50"]
        ref = jtester.Tester(jmodel, state.params, jcfg, loader, props,
                             batch_size=2).test()["AP50"]
        return port, ref

    def as_jax(sample):
        return jsampler.RoiSample(*(
            np.asarray(t.numpy(), np.int32)
            if t.dtype in (torch.int32, torch.int64) else t.numpy()
            for t in sample))

    tloop._hflip_images = rec_hflip
    tloop.sampler_lib.sample_batch = rec_sample
    MultiPathHead._dropout = rec_dropout
    jloop.sampler_lib.sample_batch = lambda *a, **k: ctx["sample"]
    fnn.Dropout.__call__ = drop
    try:
        for i, seed in enumerate(seeds):
            state = trainer.init_state(seed)
            if inits is not None:
                convert.load_flax_params(trainer.model, inits[i])
            params = jax.tree.map(
                jnp.asarray,
                convert.flax_from_state_dict(trainer.model.state_dict()))
            jstate = jloop.TrainState(jnp.zeros((), jnp.int32), params,
                                      tx.init(params), jax.random.key(0))
            run = dict(seed=seed, losses=[], metrics=[])
            before = ap50s(jstate) if evaluate else None
            for ep in range(epochs):
                for batch in pipe.epoch(ep):
                    drawn["masks"] = []
                    state, m = trainer.step(state, batch)
                    jstate, jm = jstep(jstate, jloop.Batch(*batch),
                                       drawn["flips"],
                                       as_jax(drawn["sample"]),
                                       tuple(drawn["masks"]))
                    m = {k: float(v) for k, v in m.items()}
                    jm = {k: float(v) for k, v in jm.items()}
                    run["losses"].append((m["loss"], jm["loss"]))
                    run["metrics"].append((m, jm))
            if evaluate:
                run["ap50"] = (before, ap50s(jstate))
            got = dict(_leaves(convert.flax_from_state_dict(
                trainer.model.state_dict())))
            run["drift"] = max(float(np.abs(got[n] - np.asarray(v)).max())
                               for n, v in _leaves(jstate.params))
            yield run
    finally:
        tloop._hflip_images, MultiPathHead._dropout = hflip, dropout
        tloop.sampler_lib.sample_batch = sample_batch
        jloop.sampler_lib.sample_batch = jsample_batch
        fnn.Dropout.__call__ = flax_dropout


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def main(argv):
    import numpy as np

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("package", choices=("port", "reference", "lockstep"))
    ap.add_argument("first", type=int)
    ap.add_argument("last", type=int)
    ap.add_argument("--init", choices=("port", "reference"), default=None,
                    help="draw the starting weights with this package's "
                         "initializer (default: the trainer's own)")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default=None, help="the model's compute dtype "
                    "(default: the preset's, bfloat16)")
    ap.add_argument("--pallas", action="store_true",
                    help="reference: train through its Pallas route")
    args = ap.parse_args(argv)
    own = "port" if args.package == "lockstep" else args.package
    init = (None if args.init in (None, own)
            else {"port": _port_init, "reference": _reference_init}[args.init])
    label = args.package + ("" if init is None else f" ({args.init} init)")
    seeds = range(args.first, args.last)
    with tempfile.TemporaryDirectory() as root:
        fx = fixture(root)
        if args.package == "lockstep":
            for run in lockstep(fx, seeds, init, args.dtype):
                per_epoch = np.asarray(run["losses"]).reshape(30, -1, 2)
                for ep, (lt, lj) in enumerate(per_epoch.mean(axis=1)):
                    print(f"seed {run['seed']} epoch {ep}: mean loss port "
                          f"{lt:.4f} reference {lj:.4f}")
                (bt, bj), (at, aj) = run["ap50"]
                print(f"{label} seed {run['seed']}: AP50 port {bt:.4f} -> "
                      f"{at:.4f}, reference {bj:.4f} -> {aj:.4f}; largest "
                      f"parameter difference {run['drift']:.3g}", flush=True)
            return
        runs = {"port": _port, "reference": _reference}[args.package]
        for seed, before, after, l0, l1 in runs(fx, seeds, init, args.dtype,
                                                args.pallas):
            print(f"{label} seed {seed}: AP50 {before:.4f} -> {after:.4f}, "
                  f"loss {l0:.4f} -> {l1:.4f}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
