"""``train`` command of the port — counterpart of ``yolojax/cli/train.py``.

    python -m yolojax_torch.cli.train -c config.ini [more.ini …] [--steps N] [-r] [--device cuda]
    torchrun --nproc_per_node N -m yolojax_torch.cli.train -c config.ini …   # N cards

The loop: the threaded loader's host canvases → copies to the device
overlapped on a side stream (or, with ``[data] device_dataset = 1``, the
batch gathered from the dataset on the device, ``data/device_cache.py``) →
the augmentation at this step's input size → forward (train-mode BN) →
region loss → gradients → update, eager.  As in the JAX package: the input
size is redrawn from the bucketed multi-scale sizes every ``[train]
multi_scale_interval`` steps by ``np.random.default_rng([train] seed)``;
checkpoints on a seconds cadence, on Ctrl-C and at the end (``final``),
carrying ``step`` and ``seen``; ``-r`` resumes from the newest;
per-component loss scalars, LR, histograms and box images at the
``[summary]`` cadences; ``seen`` drives the loss warmup.

What differs: the augmentation's draws come from a ``torch.Generator``
seeded from ``[train] seed + 1`` and the step (so a resumed run draws what
the uninterrupted one would have), and jax.random and torch draw different
numbers, so a port run reproduces a JAX run's input sizes and batch order
but not its pixels.  ``[train] prewarm`` runs one forward and backward per
bucketed size on a dummy batch (the allocator and cuDNN warm up) and keeps
nothing of it.  ``-f x.weights`` finetunes from darknet weights, with a fresh
head where the file's was trained for another class count.

Across devices, one process per card under torchrun, in the group that
``parallel/collectives.py::init_from_env`` starts (NCCL; ``--device cuda``
means ``cuda:LOCAL_RANK``), or in a default group the caller started
before building :class:`Train`.  The batch unit is the node, as it is the
process in the JAX package, whose one process drives every chip of its host
and splits ``[data] batch_size`` (or ``--batch``) over them: a rank trains
on ``batch_size // local_world``, where ``local_world`` is torchrun's
``LOCAL_WORLD_SIZE`` or, where that is not set, the group's size (every
rank on one machine).  The global batch is ``batch_size`` times the number
of nodes; an epoch is ``len(dataset) // batch_size`` steps and ``seen``
grows by the global batch, as in the JAX package.  Where the JAX package
shrinks its mesh until the batch splits, a rank cannot be left idle, so a
batch that does not divide over the node's ranks raises a ``ValueError``.
Each node's loader shard is its disjoint share of the seeded epoch, as a
JAX process's is (``order[node::nodes]``), and each rank of the node takes
its contiguous rows of every node batch, as the JAX process's chips do
(``Loader(shard=(node, nodes), part=(local rank, local_world))``); the
device dataset gathers each rank's contiguous rows of every global index
batch.  So the global batch is, row for row, what the JAX package
assembles from as many processes (on one node, one process's batch), and
each image takes the augmentation draw of its row (the draws are made for
the global batch, each rank applying its own rows): on one node the ranks
see the pixels one process would see on the global batch; the step averages
over the group (``parallel/mesh.py``); ``seen`` counts the global batch.
Only rank 0 writes checkpoints, summaries, box images and profiles: the
ranks of one machine share its disk, where the JAX package's processes each
write their own.  ``-r`` loads on every rank.

The RSS watchdog checkpoints and exec-restarts the process with ``-r`` when
its resident memory passes ``[train] rss_restart_fraction`` of the host's.
Across ranks it logs and does not restart, as for an in-process caller: one
rank cannot rejoin its group by exec.
"""

from __future__ import annotations

import logging
import os
import sys
import time

import numpy as np
import torch

from .. import config as _config
from ..data.cache import load_cache
from ..data.dataset import Dataset, _imread_rgb
from ..data.device_cache import DeviceDataset
from ..data.loader import Loader, overlap_device_puts
from ..data.transform import TrainAugment
from ..ops.loss import LossConfig
from ..parallel.collectives import init_from_env, local_world, rank, world
from ..parallel.mesh import batch_slice, loss_weights_from_config, make_train_step
from ..utils import checkpoint as ckpt
from ..utils.metrics import Meter, Summary
from ..utils.train import build_optimizer, with_frozen
from ..utils.visualize import draw_boxes
from . import make_parser, setup
from .common import build, load_weights_auto

_LOG = logging.getLogger(__name__)

BATCH_KEYS = ("canvas", "hw", "yx_min", "yx_max", "cls", "valid")


def _rss_gb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024 / 1024
    except OSError:
        pass
    return 0.0


def _mem_total_gb() -> float:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal"):
                    return int(line.split()[1]) / 1024 / 1024
    except OSError:
        pass
    return 0.0


def multi_scale_sizes(config) -> list[int]:
    lo = config.getint("train", "multi_scale_min", fallback=320)
    hi = config.getint("train", "multi_scale_max", fallback=608)
    return list(range(lo, hi + 1, 32))


def _to_device(tree, device):
    return {k: _to_device(v, device) if isinstance(v, dict) else torch.as_tensor(v).to(device)
            for k, v in tree.items()}


def _same_layout(got, want) -> bool:
    if isinstance(want, dict):
        return (isinstance(got, dict) and got.keys() == want.keys()
                and all(_same_layout(got[k], want[k]) for k in want))
    shape = tuple(want.shape) if isinstance(want, torch.Tensor) else np.shape(want)
    return not isinstance(got, dict) and np.shape(got) == shape


class Train:
    """The train loop; ``imread`` decodes one record's image (cv2 by default)."""

    def __init__(self, args, config, imread=_imread_rgb):
        self.args = args
        self.config = config
        if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda, but torch sees no CUDA device; "
                               "pass --device cpu to train on the CPU")
        self.group, self.device = init_from_env(args.device)
        self.world, self.lead = world(self.group), rank(self.group) == 0
        self.category, self.anchors, self.model = build(config)
        self.seed = config.getint("train", "seed", fallback=0)

        records = load_cache(config, "train")
        decoded = None
        if config.getboolean("data", "decoded_cache", fallback=False):
            decoded = os.path.join(_config.get_cache_dir(config), "decoded", "train")
        dataset = Dataset(records, canvas=_config.get_canvas(config),
                          max_boxes=config.getint("data", "max_boxes", fallback=60),
                          imread=imread, decoded_dir=decoded)
        node_batch = args.batch or config.getint("data", "batch_size", fallback=16)
        local = local_world(self.group)
        if node_batch % local:
            raise ValueError(f"[data] batch_size {node_batch} does not split over the {local} "
                             "ranks of a node: make it a multiple of LOCAL_WORLD_SIZE")
        self.batch_size = node_batch // local    # this rank's
        shard = (rank(self.group), self.world)
        if self.world % local:
            raise ValueError(f"{self.world} ranks do not make whole nodes of {local}")
        # torchrun numbers the ranks node by node: this rank's node and place in it
        node, place = divmod(shard[0], local)
        self.loader = Loader(dataset, self.batch_size,
                             workers=config.getint("data", "workers", fallback=3),
                             seed=self.seed, shard=(node, self.world // local),
                             part=(place, local))
        self.steps_per_epoch = len(dataset) // node_batch
        self.device_data = None
        if config.getboolean("data", "device_dataset", fallback=False):
            self.device_data = DeviceDataset(dataset, self.device, self.batch_size,
                                             seed=self.seed, shard=shard)
            _LOG.info("device-resident dataset: %d items, %.0f MB uploaded once",
                      len(dataset), self.device_data.nbytes / 1e6)

        self.params, self.state, meta = load_weights_auto(
            config, self.model, args.finetune, resume=args.resume, rng_seed=self.seed,
            reinit_head=True, device=self.device)
        self.optimizer = build_optimizer(config)
        if args.freeze:
            frozen = [n for pat in args.freeze.split(",") for n in self.params
                      if n == pat or n.startswith(pat.rstrip("*"))]
            self.optimizer = with_frozen(self.optimizer, self.params, frozen)
            _LOG.info("frozen layers: %s", sorted(set(frozen)))
        self.opt_state = self.optimizer.init(self.params)
        self.step = int(meta.get("step", 0))
        self.seen = int(meta.get("seen", 0))
        if args.resume and meta.get("step") is not None:
            self._resume_optimizer(ckpt.latest(_config.get_model_dir(config)))

        loss_cfg = LossConfig(
            ignore_threshold=config.getfloat("loss", "threshold", fallback=0.6),
            rescore=config.getboolean("loss", "rescore", fallback=True),
            warmup_seen=config.getint("train", "warmup_seen", fallback=12800),
            class_grad=config.get("loss", "class_grad", fallback="darknet"))
        self.augment = TrainAugment.from_config(config)
        self.train_step = make_train_step(self.model, self.optimizer,
                                          loss_weights_from_config(config), loss_cfg,
                                          augment=self.augment, group=self.group)
        self.sizes = multi_scale_sizes(config)
        self.interval = config.getint("train", "multi_scale_interval", fallback=10)
        self.rng = np.random.default_rng(self.seed)
        self.generator = torch.Generator()

        # RSS watchdog: checkpoint + exec-restart past this many GB; 0 disables
        frac = config.getfloat("train", "rss_restart_fraction", fallback=0.7)
        self.rss_limit_gb = frac * _mem_total_gb() if frac > 0 else 0.0
        self.restart_argv = None  # set by main() for real CLI invocations

        model_dir = _config.get_model_dir(config)
        self.saver = self.summary = None      # rank 0 writes
        if self.lead:
            self.saver = ckpt.Saver(model_dir,
                                    interval=config.getfloat("save", "interval", fallback=600),
                                    keep=config.getint("save", "keep", fallback=5))
            self.summary = Summary(model_dir, config)
        self.meter = Meter()
        self.profile_dir = None
        self.schedule = _config.parse_attr(config.get(
            "train", "scheduler", fallback="yolojax.utils.train.step_schedule"))(config)

    def _resume_optimizer(self, path: str) -> None:
        """Take the checkpoint's optimizer state when it has this run's
        layout; else (a JAX checkpoint, another ``--freeze``) train on with a
        fresh one."""
        if not ckpt.contains(path, "opt"):
            _LOG.info("checkpoint has no optimizer state; starting fresh")
            return
        trees, _ = ckpt.load(path, ("opt",))
        opt = trees["opt"]
        if not _same_layout(opt, self.opt_state):
            _LOG.warning("checkpoint optimizer state %s does not fit this optimizer; "
                         "reinitializing it", path)
            return
        count = int(opt.pop("count"))
        self.opt_state = {"count": count, **_to_device(opt, self.device)}

    def draws(self, batch: int) -> dict:
        """This step's augmentation draws for this rank's ``batch`` rows: the
        global batch's, from the generator seeded from ``[train] seed + 1``
        and the step, sliced to the rank's rows."""
        self.generator.manual_seed(((self.seed + 1) << 32) + self.step)
        return batch_slice(self.augment.draw(self.generator, batch * self.world), self.group)

    def prewarm(self):
        """One forward and backward per bucketed size on a dummy batch;
        params, state and optimizer stay as they are."""
        if not self.config.getboolean("train", "prewarm", fallback=True):
            return
        canvas = _config.get_canvas(self.config)
        g = self.config.getint("data", "max_boxes", fallback=60)
        b, dev = self.batch_size, self.device
        dummy = {
            "canvas": torch.full((b, canvas, canvas, 3), 127, dtype=torch.uint8, device=dev),
            "hw": torch.full((b, 2), float(canvas), device=dev),
            "yx_min": torch.zeros((b, g, 2), device=dev),
            "yx_max": torch.zeros((b, g, 2), device=dev),
            "cls": torch.zeros((b, g), dtype=torch.int32, device=dev),
            "valid": torch.zeros((b, g), dtype=torch.bool, device=dev),
        }
        draws = self.augment.draw(torch.Generator().manual_seed(0), b)
        t0 = time.time()
        for size in self.sizes:
            self.train_step(self.params, self.state, self.opt_state, dummy, 0, draws, size)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            _LOG.info("prewarmed size %d (%.1fs)", size, time.time() - t0)

    def device_batches(self):
        """This rank's batches on the device: gathered there from the
        device-resident dataset, or host batches copied a step ahead."""
        if self.device_data is not None:
            return iter(self.device_data)
        return overlap_device_puts(iter(self.loader), self.device, BATCH_KEYS)

    def save(self, tag: str = ""):
        """A checkpoint, written by rank 0 only."""
        if not self.lead:
            return
        params, state = ckpt.to_jax(self.params, self.state)
        path = self.saver(time.time(), self.step,
                          {"params": params, "state": state, "opt": self.opt_state},
                          {"step": self.step, "seen": self.seen})
        _LOG.info("saved %s %s", path, tag)

    def _maybe_restart(self):
        """Checkpoint + exec-restart when RSS crosses the watchdog limit."""
        if not self.rss_limit_gb or self.step % 50:
            return
        rss = _rss_gb()
        if rss < self.rss_limit_gb:
            return
        if self.restart_argv is None or self.world > 1:
            # an in-process caller can't exec safely, and a rank can't rejoin its group
            if not getattr(self, "_rss_warned", False):
                self._rss_warned = True
                why = ("train runs on %d ranks" % self.world if self.world > 1
                       else "train was invoked in-process")
                _LOG.warning("RSS %.1f GB exceeds the %.1f GB watchdog limit but %s; cannot "
                             "exec-restart (run the CLI on one device for self-healing)",
                             rss, self.rss_limit_gb, why)
            return
        self.save("rss-restart")
        self.summary.close()
        argv = list(self.restart_argv)   # interpreter arguments onward
        if "-r" not in argv and "--resume" not in argv:
            argv.append("-r")
        _LOG.warning("RSS %.1f GB > %.1f GB limit: exec-restarting to resume from step %d",
                     rss, self.rss_limit_gb, self.step)
        logging.shutdown()
        os.execv(sys.executable, [sys.executable] + argv)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, max_steps: int | None = None):
        epochs = self.args.epochs or self.config.getint("train", "epochs", fallback=160)
        total = max_steps or epochs * self.steps_per_epoch
        size = self.sizes[-1] if len(self.sizes) == 1 else 416
        self.prewarm()
        _LOG.info("training %d steps (%d/epoch) on %s, rank %d of %d, sizes %s", total,
                  self.steps_per_epoch, self.device, rank(self.group), self.world, self.sizes)
        profiler = None
        source = self.device_batches()
        try:
            for batch in source:
                if self.step >= total:
                    break
                if self.step % self.interval == 0:
                    size = int(self.rng.choice(self.sizes))
                draws = self.draws(self.batch_size)
                self.params, self.state, self.opt_state, metrics = self.train_step(
                    self.params, self.state, self.opt_state, batch,
                    min(self.seen, 2**31 - 1), draws, size)
                self.step += 1
                self.seen += self.batch_size * self.world
                if not self.lead:
                    continue

                if self.profile_dir is not None:  # trace a steady-state window
                    if self.step == 10:
                        profiler = torch.profiler.profile(activities=[
                            torch.profiler.ProfilerActivity.CPU,
                            *([torch.profiler.ProfilerActivity.CUDA]
                              if self.device.type == "cuda" else [])])
                        profiler.start()
                    elif self.step == 20 and profiler is not None:
                        self._sync()
                        profiler.stop()
                        self._write_profile(profiler)
                        profiler, self.profile_dir = None, None

                if self.summary.due("scalar", self.step):
                    vals = {k: float(v) for k, v in metrics.items() if k != "grads"}
                    self._sync()
                    self.meter.mark(self.batch_size * self.world
                                    * self.summary.cadence["scalar"])
                    vals["lr"] = float(self.schedule(self.step))
                    vals["images_per_sec"] = self.meter.rate
                    vals["size"] = size
                    self.summary.scalar(self.step, **vals)
                    _LOG.info("step %d size %d total %.4f (%.1f img/s)",
                              self.step, size, vals["total"], self.meter.rate)
                if self.summary.due("histogram", self.step):
                    self.summary.histogram(self.step, self.params, "params/")
                    self.summary.histogram(self.step, metrics["grads"], "grads/")
                if self.summary.due("image", self.step):
                    self._image_summary(batch, draws, size)
                if self.saver.due(time.time()):
                    self.save()
                self._maybe_restart()
        except KeyboardInterrupt:
            _LOG.info("interrupted at step %d", self.step)
        finally:
            if profiler is not None:
                profiler.stop()
            self.save("final")
            if self.summary is not None:
                self.summary.close()
        return self.step

    def _image_summary(self, batch, draws, size: int):
        """The first image of the batch, augmented with this step's draws,
        with its boxes drawn."""
        images, bmin, bmax, bvalid = self.augment.apply(
            batch["canvas"][:1], batch["hw"][:1], batch["yx_min"][:1], batch["yx_max"][:1],
            batch["valid"][:1], {k: v[:1] for k, v in draws.items()}, size)
        v = bvalid[0].cpu().numpy()
        drawn = draw_boxes(images[0].float().cpu().numpy(), bmin[0].cpu().numpy()[v],
                           bmax[0].cpu().numpy()[v], batch["cls"][0].cpu().numpy()[v],
                           category=self.category)
        self.summary.image(self.step, "train/augmented", drawn / 255.0)

    def _write_profile(self, profiler):
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, "trace.json")
        profiler.export_chrome_trace(path)
        sort = "self_cuda_time_total" if self.device.type == "cuda" else "self_cpu_time_total"
        with open(os.path.join(self.profile_dir, "ops.txt"), "w") as f:
            f.write(profiler.key_averages().table(sort_by=sort, row_limit=60))
        _LOG.info("profiler trace of steps 10-20 written to %s", self.profile_dir)


def train_parser():
    parser = make_parser("train the configured model on the cached dataset")
    parser.add_argument("-r", "--resume", action="store_true",
                        help="resume from the latest checkpoint in the model dir")
    parser.add_argument("-f", "--finetune", default=None,
                        help="initial weights: checkpoint .npz or darknet .weights")
    parser.add_argument("--batch", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--freeze", default=None, metavar="LAYERS",
                        help="comma-separated layer names (c1,c2,... or prefix*) to freeze "
                             "during finetuning")
    parser.add_argument("--steps", type=int, default=None, help="hard step cap")
    parser.add_argument("--debug-nans", action="store_true",
                        help="torch.autograd anomaly detection (names the op of a NaN)")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="capture a torch.profiler trace of steps 10-20 into DIR")
    parser.add_argument("--device", default="cuda", help="torch device (cuda | cpu)")
    return parser


def main(argv=None):
    args = train_parser().parse_args(argv)
    config = setup(args)
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    train = Train(args, config)
    if argv is None:
        # enables the RSS watchdog's exec, which reruns this module
        train.restart_argv = ["-m", __spec__.name, *sys.argv[1:]]
    if args.profile:
        train.profile_dir = args.profile
    train(max_steps=args.steps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
