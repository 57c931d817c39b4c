"""The program's own spans and counters (``engine/profiler.py``: ``span``,
``count``, ``captured``) on the CPU: nothing recorded, entered or
allocated while no ``torch.profiler`` runs; under one, a render's and a
training step's spans where the work happens, the counts a scene implies
and ``slrsfs.*`` annotations inside the profiled interval of the Chrome
trace; sums by name and a fresh start in ``profile_trace``; the
``StageProfiler`` stages on the decode spans' blocks and the trainer's
marks; and the benchmark's readers of them."""

import json
import math
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from slrsfs_tpu_torch.cli.render import SceneRenderer, outputs_to_u8
from slrsfs_tpu_torch.cli.train import attach_moving_sets, build, to_device_batch
from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.engine import profiler, rollout
from slrsfs_tpu_torch.engine.profiler import StageProfiler, profile_trace

torch.set_num_threads(1)

TINY = "resnet_TinyTest_de_resnet_pconv2_nonorm"
W, N, DB = 64, 4, 2
TRAIN_W, B, T = 32, 2, 4

# every span of a cropped render, with the times it runs a scene
RENDER_SPANS = {"render.sparsify": 1, "render.moving_set": 1, "render.upload": 1,
                "rollout.crop_plan": 1, "rollout.static_decode": 1,
                "rollout.decode": N // DB, "render.d2h": 1}
TIMED = {"rollout.static_decode", "rollout.decode", "render.d2h"}
MARKS = ["G forward", "G backward", "D step", "updates"]


@pytest.fixture(autouse=True)
def clean():
    profiler.reset()
    yield
    profiler.reset()


@pytest.fixture(scope="module")
def renderer():
    return SceneRenderer(W=W, n_frames=N, decode_batch=DB, sparsify_eps=0.05,
                         opt_overrides=dict(ngf=8, out_channel=9, refine_model_type=TINY),
                         device="cpu")


def _scene(seed=0):
    """A band of rows 40-51 moving right one pixel a frame over sub-eps
    noise: its crop window is rows 20-63 of the 64."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1.0, 1.0, (W, W, 3)).astype(np.float32)
    flow = (rng.standard_normal((W, W, 2)) * 0.01).astype(np.float32)
    flow[40:52, 8:56, 0] += 1.0
    return img, flow


def _render(r, seed=0):
    img, flow = _scene(seed)
    motion = r.scene_flow(img, flow, f"scene{seed}")
    return outputs_to_u8(r.frames(img, motion))


def _crop(r, seed=0):
    img, flow = _scene(seed)
    _, flow_t, pos_t, val_t = r._tensors(img, r.scene_flow(img, flow, "plan"))
    return rollout.prepare_crop(r.opt, False, flow_t, pos_t, val_t, N)[1]


@pytest.fixture(scope="module")
def trainer_and_batch():
    opt = Options(W=TRAIN_W, batch_size=B, ngf=8, out_channel=9, refine_model_type=TINY,
                  ndf=8, num_D=1, n_layers_D=2)
    _, tr = build(opt, train_max_steps=T, device="cpu", seed=0)
    rng = np.random.default_rng(1)
    motions = np.zeros((B, TRAIN_W, TRAIN_W, 2), np.float32)
    motions[:, 8:20, 4:28] = rng.standard_normal((B, 12, 24, 2)) * 0.5 + 0.7
    batch = {"images": [(rng.standard_normal((B, TRAIN_W, TRAIN_W, 3)) * 0.25
                         ).astype(np.float32) for _ in range(3)],
             "index": np.array([[0, 2, T]] * B, np.int32),
             "motions": motions}
    return tr, batch


def _step(tr, batch, timer=None):
    b = attach_moving_sets(batch, n_steps=T)
    assert "mov_pos" in b  # the compact K7 path
    return tr.train_step(to_device_batch(b, "cpu"), timer=timer)


def test_nothing_recorded_without_a_profiler(renderer, trainer_and_batch, monkeypatch):
    """A render and a training step with no profiler running: no
    ``slrsfs.*`` ``record_function`` entered, no CUDA event made, and
    ``captured()`` empty."""
    entered = []
    real = torch.profiler.record_function

    def spy(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    def no_event(*a, **k):
        raise AssertionError("a CUDA event was made")

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    _render(renderer)
    _step(*trainer_and_batch)
    assert [n for n in entered if n.startswith("slrsfs.")] == []
    assert profiler.captured() == {"spans": {}, "counters": {}}


def test_span_off_allocates_nothing(monkeypatch):
    """With no profiler running a span and a counter allocate nothing in
    ``engine/profiler.py`` and enter no ``record_function``."""
    def refuse(*a, **k):
        raise AssertionError("entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)

    def loop(n):
        for _ in range(n):
            with profiler.span("x", timed=True), profiler.span("y"):
                profiler.count("render.scenes")

    loop(100)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        loop(1000)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = [tracemalloc.Filter(True, profiler.__file__)]
    grown = [d for d in after.filter_traces(mine).compare_to(
        before.filter_traces(mine), "filename") if d.size_diff > 0]
    assert grown == []
    assert profiler.captured() == {"spans": {}, "counters": {}}


def test_render_spans_counters_and_trace(renderer, tmp_path):
    """Two scenes under ``torch.profiler``: each span of the render as often
    as a scene runs it, twice; the counters the scenes imply (N frames
    each; decoded and kept pixels from the crop plan); timed spans with a
    device time (the host clock here); and every ``slrsfs.*`` annotation
    of the Chrome trace inside the profiled slice, the crop plan's inside
    no other span of the program."""
    crop = _crop(renderer)
    assert crop is not None and crop.hc < W
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.slice"):
            for seed in (0, 0):
                u8 = _render(renderer, seed)
    assert u8["PredImg"].shape == (N, W, W, 3)
    c = profiler.captured()
    spans = c["spans"]
    assert {k: v["n"] for k, v in spans.items()} == {k: 2 * n for k, n in RENDER_SPANS.items()}
    for name, s in spans.items():
        assert s["host_s"] > 0.0, name
        assert (s["device_s"] is not None) == (name in TIMED), name
    assert spans["rollout.decode"]["device_s"] > 0.0
    decoded = N * crop.hc * crop.wc + W * W
    kept = N * crop.ph * crop.pw + W * W - crop.ph * crop.pw
    assert c["counters"] == {"render.scenes": 2, "render.frames": 2 * N,
                             "rollout.decoded_px": 2 * decoded, "rollout.kept_px": 2 * kept}
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"]
    (sl,) = [e for e in events if e["name"] == "test.slice"]
    ours = [e for e in events if e["name"].startswith("slrsfs.")]
    assert {e["name"] for e in ours} == {"slrsfs." + n for n in RENDER_SPANS}
    assert len(ours) == sum(s["n"] for s in spans.values())
    for e in ours:
        assert sl["ts"] <= e["ts"] and e["ts"] + e["dur"] <= sl["ts"] + sl["dur"], e["name"]
    plans = [e for e in ours if e["name"] == "slrsfs.rollout.crop_plan"]
    for p in plans:
        assert not [e for e in ours if e is not p and e["ts"] < p["ts"]
                    and p["ts"] + p["dur"] < e["ts"] + e["dur"]]


def test_uncropped_scene_counts_whole_frames(renderer):
    """A scene whose plan is None counts H·W a frame as both decoded and
    kept pixels, and has no static decode."""
    r = SceneRenderer(W=W, n_frames=N, decode_batch=DB, crop_decode="off",
                      opt_overrides=dict(ngf=8, out_channel=9, refine_model_type=TINY),
                      device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        _render(r)
    c = profiler.captured()
    assert c["counters"]["rollout.decoded_px"] == N * W * W
    assert c["counters"]["rollout.kept_px"] == N * W * W
    assert "rollout.static_decode" not in c["spans"]
    assert "rollout.crop_plan" not in c["spans"]


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_stage_profiler_stages_with_the_decode_spans(renderer, traced):
    """``baseline_rollout_sparse`` with a ``StageProfiler`` and a crop,
    integrating itself: the four reference stages are filled with or
    without a profiler; under one, t_decoder's blocks are the decode spans
    (``profiler.STAGE_OF``) and no other span is recorded."""
    img, flow = _scene()
    motion = renderer.scene_flow(img, flow, "s")
    img_t, flow_t, pos_t, val_t = renderer._tensors(img, motion)
    crop = rollout.prepare_crop(renderer.opt, False, flow_t, pos_t, val_t, N)[1]
    profiler.reset()
    stages = StageProfiler("cpu")
    with profile(activities=[ProfilerActivity.CPU]) if traced else torch.no_grad():
        rollout.baseline_rollout_sparse(renderer.model, img_t, flow_t, N, pos_t, val_t,
                                        decode_batch=DB, crop=crop, stages=stages)
    assert set(stages.times) == {"t_encoder", "t_euler_integration",
                                 "t_softmax_splating", "t_decoder"}
    assert all(v > 0.0 for v in stages.sums().values())
    spans = profiler.captured()["spans"]
    if not traced:
        assert spans == {}
        return
    assert set(spans) == {"rollout.static_decode", "rollout.decode"}
    assert (spans["rollout.decode"]["n"] + spans["rollout.static_decode"]["n"]
            == len(stages.times["t_decoder"]))


@pytest.mark.parametrize("with_mesh", [False, True], ids=["one", "mesh"])
def test_trainer_marks_and_batch_prep_spans(trainer_and_batch, with_mesh):
    """A training step under ``torch.profiler`` with a timer: the marks in
    their order (with a mesh, "all-reduce" before "updates"); the batch
    preparation's two spans and one ``train.steps``."""
    tr, batch = trainer_and_batch
    mesh = None
    if with_mesh:
        from slrsfs_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(device="cpu")
        tr = build(tr.opt, train_max_steps=T, device="cpu", seed=0, mesh=mesh)[1]
    seen = []
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            logs = _step(tr, batch, seen.append)
    finally:
        if mesh is not None:
            mesh.close()
    assert math.isfinite(float(logs["Total Loss"]))
    marks = MARKS[:]
    if with_mesh:
        marks.insert(3, "all-reduce")
    assert seen == marks
    c = profiler.captured()
    assert {k: v["n"] for k, v in c["spans"].items()} == {"train.moving_sets": 1,
                                                          "train.upload": 1}
    assert c["counters"] == {"train.steps": 1}


def test_captured_sums_spans_by_name():
    """Spans are summed a name as they end: ``n`` and ``host_s`` over every
    run, nested runs of one name included; a timed name's ``device_s``
    (the host clock without CUDA), None for a name never timed; spans
    still open left out."""
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with profiler.span("a", timed=True), profiler.span("a"):
                profiler.count("k", 2)
        with profiler.span("b"):
            mid = profiler.captured()
    assert "b" not in mid["spans"] and mid["spans"]["a"]["n"] == 6
    c = profiler.captured()
    assert c["counters"] == {"k": 6}
    a, b = c["spans"]["a"], c["spans"]["b"]
    assert a["n"] == 6 and b["n"] == 1 and b["device_s"] is None
    assert 0.0 < a["device_s"] <= a["host_s"]


def test_profile_trace_starts_anew(tmp_path):
    """``profile_trace`` forgets what an earlier profiler recorded and
    writes its trace with the new stretch's ``slrsfs.*`` spans."""
    with profile(activities=[ProfilerActivity.CPU]):
        with profiler.span("old"):
            profiler.count("render.scenes")
    with profile_trace(str(tmp_path)):
        with profiler.span("new", timed=True):
            profiler.count("render.frames", 4)
    c = profiler.captured()
    assert set(c["spans"]) == {"new"} and c["counters"] == {"render.frames": 4}
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "slrsfs.new" in names and "slrsfs.old" not in names


READERS = {"scene_prep_ms_per_scene": "render", "d2h_ms_per_scene": "render",
           "decode_ms_per_frame": "render", "decode_fill_pct": "render",
           "batch_prep_ms_per_step": "train"}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_a_capture_and_not_an_empty_one(renderer, trainer_and_batch, name):
    """Each reader of the program's spans: ``None`` from an empty capture,
    a finite number from a CPU capture of its kind of cell."""
    from benchmark.harness import Readings, load_reader

    reader = load_reader(name)
    r = Readings(cell={}, traffic={}, config={})
    assert reader.read(r) is None
    with profile(activities=[ProfilerActivity.CPU]):
        if READERS[name] == "render":
            _render(renderer)
        else:
            _step(*trainer_and_batch)
    v = reader.read(r)
    assert v is not None and math.isfinite(v) and v > 0.0
    if name == "decode_fill_pct":
        assert 0.0 < v <= 100.0
