"""The program's spans (`spcl_torch/utils/profiling.py::span`) on the CPU,
one torch thread, tiny UNets:

- with the profiler off `span()` hands out one shared null context and
  never reaches `record_function` (patched to raise); no time is asserted
  (PERF.md holds the cost a call, measured);
- torch's private flag `torch.autograd.profiler._is_profiler_enabled`, which
  `span` reads, is there and follows the profiler;
- under `torch.profiler` one pretrain, fine-tune, semi (mean teacher, EMA)
  and gradient-cache step each hold every span they should, once a step,
  in order and nested as the steps' docstrings list them, the UNet's
  `spcl.unet.*` stage spans inside the forwards (the teacher's too);
- a step's outputs and updated weights are bit-identical with the profiler
  on and off;
- an epoch's boundary (the trainer's own methods and the hooks'
  `on_epoch_end`) holds the `spcl.epoch.*` spans.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from spcl_torch.data import augment as aug
from spcl_torch.data.packing import synthetic_dataset
from spcl_torch.entry import build_trainer
from spcl_torch.hooks import SelfPacedINFONCEHook, creator
from spcl_torch.hooks.base import get_individual_hooks
from spcl_torch.models import EMATeacher, UNet, set_trainable_stages, stages_from_range
from spcl_torch.training import (batch_to_device, build_finetune_step,
                                 build_gradcache_pretrain_step, build_optimizer,
                                 build_pretrain_step, build_semi_step, deferred)
from spcl_torch.utils import profiling
from spcl_torch.utils.utils import fix_all_seed

from test_torch_trainer_features import _config as trainer_config

CANVAS, CROP, MAXC = 40, 32, 32
ENCODER = tuple(f"spcl.unet.{s}" for s in ("Conv1", "Conv2", "Conv3", "Conv4", "Conv5"))
WHOLE = ENCODER + tuple(f"spcl.unet.{s}" for s in ("Up_conv5", "Up_conv4", "Up_conv3",
                                                    "Up_conv2", "Deconv_1x1"))
KINDS = ("pretrain", "finetune", "semi", "gradcache")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread (see tests/test_torch_semi_step.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ span()
def test_profiler_flag_follows_the_profiler():
    assert autograd_profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert isinstance(profiling.span("spcl.step"), torch.profiler.record_function)
    assert autograd_profiler._is_profiler_enabled is False


def test_span_off_is_one_shared_null_context(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function reached with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    shared = profiling.span("spcl.step")
    for name in ("spcl.step.input", "spcl.unet.Conv1", "spcl.epoch.drain") * 3:
        ctx = profiling.span(name)
        assert ctx is shared
        with ctx as entered:
            assert entered is None


# ------------------------------------------------------------------ steps
def _dataset():
    return synthetic_dataset("acdc", num_scans=4, canvas=CANVAS, seed=0)


def _rows(n, seed):
    return np.random.default_rng(seed).choice(len(_dataset().images), n, replace=False)


def _unet(layout="nhwc", max_channel=MAXC):
    torch.manual_seed(0)
    return UNet(input_dim=1, num_classes=4, max_channel=max_channel, small_c_layout=layout)


def _pretrain_parts(grad_cache=0):
    net = _unet()
    set_trainable_stages(net, stages_from_range(None, "Conv5"))
    hook = SelfPacedINFONCEHook(name="sp", feature_name="Conv5", contrast_on="partition",
                                begin_value=3.0, end_value=14.0, mode="soft", max_epoch=4)
    torch.manual_seed(1)
    hook.build(net, "cpu")
    params = [p for p in net.parameters() if p.requires_grad] + list(hook.parameters())
    opt = build_optimizer(params, lr=1e-3, weight_decay=1e-5)
    kwargs = dict(policy=aug.AugmentPolicy(crop=CROP, rot_degrees=10.0), total_freedom=True,
                  until="Conv5")
    if grad_cache:
        step = build_gradcache_pretrain_step(net, [hook], opt, num_chunks=grad_cache, **kwargs)
    else:
        step = build_pretrain_step(net, [hook], opt, **kwargs)
    batch = batch_to_device(_dataset().batch(_rows(4, 2)), "cpu")
    scalars = {"sp": hook.epoch_scalars(0)}

    def run(gen):
        return step(batch, gen, scalars)
    return run, [net, hook.projector]


def _finetune_parts():
    net = _unet()
    opt = build_optimizer(list(net.parameters()), lr=1e-3, weight_decay=1e-5)
    step = build_finetune_step(net, opt, num_classes=4,
                               policy=dataclasses.replace(aug.ACDC_LABEL, crop=CROP))
    batch = batch_to_device(_dataset().batch(_rows(3, 3)), "cpu")
    return (lambda gen: step(batch, gen)), [net]


def _semi_parts():
    net = _unet()
    hooks = get_individual_hooks(creator.create_mt_hook(weight=10.0))
    opt = build_optimizer(list(net.parameters()), lr=1e-3, weight_decay=1e-5)
    teacher = EMATeacher(net)
    step = build_semi_step(net, hooks, opt, num_classes=4,
                           policy=dataclasses.replace(aug.ACDC_LABEL, crop=CROP),
                           teacher=teacher)
    ds = _dataset()
    batch_l = batch_to_device(ds.batch(_rows(3, 4)), "cpu")
    batch_u = batch_to_device(ds.batch(_rows(3, 5)), "cpu")
    return (lambda gen: step(batch_l, batch_u, gen, {})), [net, teacher.model]


PARTS = {"pretrain": _pretrain_parts, "finetune": _finetune_parts, "semi": _semi_parts,
         "gradcache": lambda: _pretrain_parts(grad_cache=2)}


def _spans(run, tmp_path):
    """The `spcl.` spans of run() under torch.profiler, as a tree of
    (name, [children]) by their nesting on the host clock."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                     if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                     and e["name"].startswith("spcl.")),
                    key=lambda e: (e["ts"], -e["dur"]))
    root, stack = [], []
    for e in events:
        while stack and e["ts"] >= stack[-1][0]["ts"] + stack[-1][0]["dur"]:
            stack.pop()
        node = (e["name"], [])
        (stack[-1][1][1] if stack else root).append(node)
        stack.append((e, node))
    return out, root


def _flat(tree):
    return [(name, _flat(kids)) if kids else name for name, kids in tree]


def _forward(stages):
    return ("spcl.step.forward", list(stages))


CHUNK = ["spcl.step.input", _forward(ENCODER)]
EXPECTED = {
    "pretrain": ["spcl.step.input", _forward(ENCODER), "spcl.step.loss", "spcl.step.backward",
                 "spcl.step.optimizer"],
    "finetune": ["spcl.step.input", _forward(WHOLE), "spcl.step.loss", "spcl.step.backward",
                 "spcl.step.optimizer", "spcl.step.loss"],
    "semi": ["spcl.step.input", _forward(WHOLE), ("spcl.step.teacher", list(WHOLE)),
             "spcl.step.loss", "spcl.step.backward", "spcl.step.optimizer", "spcl.step.ema",
             "spcl.step.loss"],
    "gradcache": ["spcl.step.input",
                  ("spcl.gradcache.pass_a", CHUNK + CHUNK + ["spcl.step.forward"]),
                  "spcl.step.loss", "spcl.step.backward",
                  *CHUNK, "spcl.step.backward", *CHUNK, "spcl.step.backward",
                  "spcl.step.optimizer"],
}


@pytest.mark.parametrize("kind", KINDS)
def test_step_holds_its_spans_in_order(kind, tmp_path):
    run, _ = PARTS[kind]()
    _, tree = _spans(lambda: run(torch.Generator().manual_seed(7)), tmp_path)
    assert _flat(tree) == [("spcl.step", EXPECTED[kind])]


def _leaves(tree):
    if torch.is_tensor(tree):
        return [tree.detach().clone()]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [torch.tensor(float(tree))]


@pytest.mark.parametrize("kind", KINDS)
def test_step_is_bit_identical_with_the_profiler_on(kind, tmp_path):
    got = []
    for traced in (False, True):
        run, modules = PARTS[kind]()
        step = lambda: run(torch.Generator().manual_seed(7))  # noqa: E731
        out = _spans(step, tmp_path)[0] if traced else step()
        got.append(_leaves(out) + [t.detach().clone() for m in modules
                                   for t in m.state_dict().values()])
    assert len(got[0]) == len(got[1])
    for a, b in zip(*got):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_pallas_stages_hold_their_spans(tmp_path):
    """Under `small_c_layout: pallas` the fused Conv1 / Conv2 (their pools
    inside) run in the same stage spans as the plain path's."""
    net = _unet("pallas", 256).train()
    x = torch.rand(2, 1, 32, 32)
    assert net._use_fused_stages(x)
    _, tree = _spans(lambda: net(x, until="Conv3"), tmp_path)
    assert _flat(tree) == list(ENCODER[:3])


# ------------------------------------------------------------------ epoch
def test_epoch_boundary_holds_its_spans(tmp_path):
    fix_all_seed(10)
    tr = build_trainer(trainer_config("pretrain_encoder"), save_dir=str(tmp_path / "run"),
                       pretrain=True, device="cpu")
    tr.init()
    tr._cur_epoch = 1

    def epoch():
        record = tr._dispatch_train_epoch()
        tr._epoch_stats(record, deferred.drain([record])[0])
        tr._end_epoch()

    _, tree = _spans(epoch, tmp_path)
    names = [name for name, _ in tree]
    assert names == ["spcl.epoch.schedule", "spcl.epoch.schedule", "spcl.epoch.rows",
                     "spcl.epoch.upload", "spcl.step", "spcl.step", "spcl.epoch.drain",
                     "spcl.epoch.drain", "spcl.epoch.stats"] + ["spcl.epoch.schedule"] * len(
                         tr.hooks)
