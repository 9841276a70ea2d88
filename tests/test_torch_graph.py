"""The scan family's step as one CUDA graph (``utils.cudagraph``).

On the CPU, where there are no graphs:

- ``make_scan_step_fn(_graph=True)`` raises, and so does a
  ``GraphedStep`` for the CPU; the default there is the eager step, bit for
  bit ``_graph=False``, at ``make_scan_step_fn`` and at the doors that
  step through it (``run_sequence_scan``, the resumable scan, the chunked
  batched runner).
- The static buffers the graph replays: a state's tensors out and back in
  (``state_tensors`` / ``with_tensors``), the outputs packed into one byte
  row and unpacked from a stack of rows (``OutputLayout``), and the whole
  replay loop (``_StaticStep.run`` with its body run eagerly in place of a
  replay, exactly what a capture records) against the eager scan bit for
  bit, single and batched, with and without track snapshots: outputs,
  final state and the generators' state.
- The foreign-state rule (the state returned last is not copied in, any
  other state is), a state carrying other generator objects drawing what
  it would have drawn eagerly, the generator hand-over on CPU generators,
  the write-back of a new state that aliases the static one, and the
  per-replay launch accounting.

On a card (``cuda`` marker, skipped here): graphed against eager bit for
bit on a small course, single and batched; the generators' state after k
replays; a resume from a graphed scan's checkpoint against the
uninterrupted run; a capture that cannot proceed raises.

Alone on the CPU this file takes ~30 s (one core).
"""

import functools

import numpy as np
import pytest
import torch

from visual_odom_tpu_torch.backend import pnp
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
from visual_odom_tpu_torch.ops import lk_cuda
from visual_odom_tpu_torch.ops.lk import lk_track_pyramid
from visual_odom_tpu_torch.parallel import batch
from visual_odom_tpu_torch.parallel.batch_eval import run_sequences_batched
from visual_odom_tpu_torch.runner import pipeline
from visual_odom_tpu_torch.utils import cudagraph

torch.set_num_threads(1)

H, W = 120, 160
INTR = dict(fx=120.0, fy=120.0, cx=80.0, cy=60.0, bf=-64.8, width=W, height=H)
#: the plain LK quad makes a CPU step ~0.4 s at this size; neither count
#: changes what the static buffers must reproduce
CFG = dict(ransac_iterations=100, lk_max_iters=10)
#: frames of the course: a first chunk of 2 steps and a second of 1
N_FRAMES = 4


@pytest.fixture(scope="module")
def setup():
    intr = CameraIntrinsics(**INTR)
    cfg = VOConfig.for_image(H, W, **CFG)
    seqs = [SyntheticStereoSequence(intr, num_frames=N_FRAMES, seed=s)
            for s in (0, 1)]
    frames = [[seq.frame(i) for i in range(N_FRAMES)] for seq in seqs]
    return cfg, intr, frames


def _stacks(frames, batched):
    """(lefts, rights) of frames 1.. as tensors: (k, H, W), or (k, 2, H, W)
    for the two sequences in lockstep."""
    if not batched:
        frames = frames[0]
        return tuple(torch.from_numpy(np.stack([f[k] for f in frames[1:]]))
                     for k in (0, 1))
    return tuple(torch.from_numpy(np.stack([np.stack([s[i][k] for s in frames])
                                            for i in range(1, N_FRAMES)]))
                 for k in (0, 1))


def _init(cfg, intr, frames, batched, seed=3):
    if batched:
        return batch.batched_init_state(
            cfg, *(np.stack([s[0][k] for s in frames]) for k in (0, 1)),
            seed=seed, device="cpu")
    return pipeline.init_vo_state(cfg, intr, *frames[0][0], seed=seed,
                                  device="cpu")


def _equal(a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and bool(torch.equal(a, b)))


def _same_outputs(xs, ys) -> bool:
    return all(type(x) is type(y) and all(_equal(u, v) for u, v in zip(x, y))
               for x, y in zip(xs, ys))


def _same_state(a, b) -> bool:
    return (all(_equal(x, y) for x, y in zip(cudagraph.state_tensors(a),
                                             cudagraph.state_tensors(b)))
            and all(_equal(x.get_state(), y.get_state())
                    for x, y in zip(cudagraph.generators(a),
                                    cudagraph.generators(b))))


@pytest.fixture(scope="module")
def eager_runs(setup):
    """The eager scan over the course in chunks of 2 and 1, per (batched,
    tracks): (final state, [outputs per chunk])."""
    cfg, intr, frames = setup
    runs = {}
    for batched in (False, True):
        lefts, rights = _stacks(frames, batched)
        for tracks in (False, True):
            scan = pipeline.make_scan_step_fn(cfg, intr, with_tracks=tracks,
                                              device="cpu", _graph=False)
            state = _init(cfg, intr, frames, batched)
            state, *a = scan(state, lefts[:2], rights[:2])
            state, *b = scan(state, lefts[2:], rights[2:])
            runs[batched, tracks] = state, [a, b]
    return runs


# --- no graphs on the CPU ---------------------------------------------------


@pytest.mark.parametrize("builder", ["make_scan_step_fn", "GraphedStep"])
def test_graph_on_cpu_raises(setup, builder):
    cfg, intr, _ = setup
    calls = {
        "make_scan_step_fn": lambda: pipeline.make_scan_step_fn(
            cfg, intr, device="cpu", _graph=True),
        "GraphedStep": lambda: cudagraph.GraphedStep(
            pipeline.make_step_fn(cfg, intr, device="cpu"), "cpu")}
    with pytest.raises(ValueError, match="CUDA graph needs a card"):
        calls[builder]()


def _eager_scan_fn(monkeypatch):
    """Route the doors to ``make_scan_step_fn(_graph=False)``."""
    from visual_odom_tpu_torch.parallel import batch as batch_mod

    eager = functools.partial(pipeline.make_scan_step_fn, _graph=False)
    monkeypatch.setattr(pipeline, "make_scan_step_fn", eager)
    monkeypatch.setattr(batch_mod, "make_scan_step_fn", eager)


@pytest.mark.parametrize("door", ["make_scan_step_fn", "run_sequence_scan",
                                  "run_sequence_scan_resumable",
                                  "run_sequences_batched"])
def test_cpu_default_is_the_eager_step(setup, door, monkeypatch):
    """On the CPU the scan family steps eagerly by default: bit for bit
    ``make_scan_step_fn(_graph=False)``, and no graph is asked for."""
    cfg, intr, frames = setup
    if door == "make_scan_step_fn":
        scan = pipeline.make_scan_step_fn(cfg, intr, device="cpu")
        assert not isinstance(getattr(scan, "__self__", None),
                              cudagraph.GraphedStep)
    runs = {
        "make_scan_step_fn": lambda: pipeline.make_scan_step_fn(
            cfg, intr, device="cpu")(_init(cfg, intr, frames, False),
                                     *_stacks(frames, False))[1],
        "run_sequence_scan": lambda: pipeline.run_sequence_scan(
            frames[0], cfg, intr, chunk=2, warmup=False, device="cpu")[:2],
        "run_sequence_scan_resumable": lambda: (
            pipeline.run_sequence_scan_resumable(
                _Frames(frames[0]), cfg, intr, "", chunk=2, warmup=False,
                device="cpu")[:2]),
        "run_sequences_batched": lambda: run_sequences_batched(
            frames, cfg, intr, chunk=2, device="cpu")[0]}
    default = _flat(runs[door]())
    _eager_scan_fn(monkeypatch)
    eager = _flat(runs[door]())
    assert default and len(default) == len(eager)
    assert all(a.dtype == b.dtype and a.shape == b.shape
               and a.tobytes() == b.tobytes()
               for a, b in zip(default, eager))


def _flat(x) -> list:
    """The arrays of nested tuples of tensors or arrays, as numpy."""
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    if isinstance(x, np.ndarray):
        return [x]
    return [a for v in x for a in _flat(v)]


class _Frames:
    """A frame list as the resumable runner takes it."""

    def __init__(self, frames):
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def frame(self, i):
        return self.frames[i]


# --- the static buffers -----------------------------------------------------


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_state_tensors_round_trip(setup, batched):
    """A state's tensors out and into another state: every tensor in field
    order, every other leaf (pyramid sizes, pad, generators) kept."""
    cfg, intr, frames = setup
    state = _init(cfg, intr, frames, batched)
    ts = cudagraph.state_tensors(state)
    assert len(ts) == 7 + 2 * len(state.lk_l0.pyramid) + 1
    clones = [t.clone() for t in ts]
    back = cudagraph.with_tensors(state, clones)
    assert type(back) is type(state)
    assert all(x is y for x, y in zip(cudagraph.state_tensors(back), clones))
    assert back.lk_l0.shapes == state.lk_l0.shapes
    assert back.lk_l0.pad == state.lk_l0.pad
    assert all(a is b for a, b in zip(cudagraph.generators(back),
                                      cudagraph.generators(state)))
    with pytest.raises(ValueError, match="more tensors"):
        cudagraph.with_tensors(state, clones + [clones[0]])


@pytest.mark.parametrize("tracks", [False, True], ids=["outputs", "tracks"])
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_output_rows_unpack_to_the_stacked_outputs(eager_runs, batched,
                                                   tracks):
    """Each frame's outputs packed into one byte row, the rows stacked, and
    the stack unpacked: the outputs stacked along k, bit for bit, as
    NamedTuples of their own types."""
    _, (chunk, _) = eager_runs[batched, tracks]
    frames = [tuple(type(o)(*(x[i] for x in o)) for o in chunk)
              for i in range(2)]
    layout = cudagraph.OutputLayout(frames[0])
    stack = torch.zeros((2, layout.nbytes), dtype=torch.uint8)
    for i, outs in enumerate(frames):
        stack[i, :layout.used] = layout.pack(outs)
    assert layout.nbytes % 8 == 0 and layout.used <= layout.nbytes
    got = layout.unpack(stack)
    assert _same_outputs(got, chunk)
    assert all(x.is_contiguous() for o in got for x in o)
    assert all(np.array_equal(x, y) for x, y in zip(
        pipeline._fetch_chunks([got])[0][0], pipeline._fetch(chunk[0])))


def test_output_layout_refuses_other_outputs(eager_runs):
    _, (chunk, _) = eager_runs[False, False]
    out = type(chunk[0])(*(x[0] for x in chunk[0]))
    layout = cudagraph.OutputLayout([out])
    with pytest.raises(ValueError, match="laid out as"):
        layout.pack([out._replace(scale=out.scale.double())])


@pytest.mark.parametrize("tracks", [False, True], ids=["outputs", "tracks"])
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_static_step_equals_eager_scan(setup, eager_runs, batched, tracks):
    """The loop a graph replays, with its recorded body run eagerly in each
    replay's place: the state copied into the buffers, each frame copied
    in, stepped, its outputs packed and copied out, the new state written
    back, the state cloned out at the chunk's end. Bit for bit the eager
    scan: every output, the final state, the generators' state; the
    caller's generators are the ones returned, advanced."""
    cfg, intr, frames = setup
    lefts, rights = _stacks(frames, batched)
    step = pipeline.make_step_fn(cfg, intr, with_tracks=tracks, device="cpu")
    state = _init(cfg, intr, frames, batched)
    static = cudagraph._StaticStep(step, state, lefts[0], rights[0])
    static.body()                       # the capture's warm-up
    got, *a = static.run(state, lefts[:2], rights[:2], static.body)
    got, *b = static.run(got, lefts[2:], rights[2:], static.body)
    ref, (ra, rb) = eager_runs[batched, tracks]
    assert _same_outputs(a, ra) and _same_outputs(b, rb)
    assert _same_state(got, ref)
    assert all(a is b for a, b in zip(cudagraph.generators(got),
                                      cudagraph.generators(state)))
    assert static.loads == 1            # the first state only


def test_foreign_state_is_copied_and_returned_state_is_not(setup):
    """A call with the state returned last copies nothing in; a call with
    any other state (here the returned state's predecessor, stepped again)
    copies it in and gives what the eager step gives from it."""
    cfg, intr, frames = setup
    lefts, rights = _stacks(frames, False)
    step = pipeline.make_step_fn(cfg, intr, device="cpu")
    state = _init(cfg, intr, frames, False)
    static = cudagraph._StaticStep(step, state, lefts[0], rights[0])
    static.body()
    s1, _ = static.run(state, lefts[:1], rights[:1], static.body)
    assert static.loads == 1
    s2, _ = static.run(s1, lefts[1:2], rights[1:2], static.body)
    assert static.loads == 1
    gen = s1.generator.get_state()
    s2b, out = static.run(s1, lefts[1:2], rights[1:2], static.body)
    assert static.loads == 2
    eager = pipeline.make_scan_step_fn(cfg, intr, device="cpu", _graph=False)
    s1.generator.set_state(gen)
    ref, ref_out = eager(s1, lefts[1:2], rights[1:2])
    assert _same_state(s2b, ref) and _same_outputs([out], [ref_out])


def test_state_with_other_generators_draws_as_eager(setup):
    """A state that arrives with generator objects the buffers have never
    seen (a restored snapshot) draws what the eager step draws with them,
    and its generators end where eager's end."""
    cfg, intr, frames = setup
    lefts, rights = _stacks(frames, False)
    step = pipeline.make_step_fn(cfg, intr, device="cpu")
    first = _init(cfg, intr, frames, False, seed=1)
    static = cudagraph._StaticStep(step, first, lefts[0], rights[0])
    static.body()
    static.run(first, lefts[:1], rights[:1], static.body)
    other = _init(cfg, intr, frames, False, seed=7)
    got, out = static.run(other, lefts[:2], rights[:2], static.body)
    eager = pipeline.make_scan_step_fn(cfg, intr, device="cpu", _graph=False)
    ref, ref_out = eager(_init(cfg, intr, frames, False, seed=7), lefts[:2],
                         rights[:2])
    assert _same_state(got, ref) and _same_outputs([out], [ref_out])
    assert got.generator is other.generator


def test_hand_over_gives_the_original_draws():
    """CPU generators: after the hand-over each draws what its source
    draws, and a generator handed to itself is left alone."""
    src = [torch.Generator().manual_seed(s) for s in (5, 6)]
    torch.rand(3, generator=src[0])
    dst = [torch.Generator().manual_seed(0) for _ in src]
    cudagraph.hand_over(dst, src)
    for d, s in zip(dst, src):
        assert torch.equal(torch.rand(8, generator=d),
                           torch.rand(8, generator=s))
    state = src[1].get_state()
    cudagraph.hand_over(src[1:], src[1:])
    assert torch.equal(src[1].get_state(), state)
    with pytest.raises(ValueError, match="generators"):
        cudagraph.hand_over(dst, src[:1])


def test_write_back_clones_a_new_state_that_aliases_the_static_one():
    """A new tensor that is a shifted view of a static tensor is read whole
    before anything is written; one that is exactly its destination is
    left alone; another structure raises."""
    static = [torch.arange(6.0), torch.arange(4.0)]
    base = torch.arange(10.0)
    static[0] = base[:6]
    shifted = base[2:8]                 # overlaps static[0], shifted by 2
    cudagraph.write_back(static, [shifted, static[1]])
    assert torch.equal(static[0], torch.arange(2.0, 8.0))
    assert torch.equal(static[1], torch.arange(4.0))
    with pytest.raises(ValueError, match="another structure"):
        cudagraph.write_back(static, [static[1], static[0]])


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_each_replay_adds_its_launches():
    """The launches a capture recorded per replay are added to the kernel
    wrappers' counts at each replay, and only there."""
    before = cudagraph.launch_counts()
    assert before == {"quad": lk_cuda.lk_circular_quad.launches,
                      "quad_batched": lk_cuda.lk_circular_quad.batched_launches,
                      "level": lk_track_pyramid.launches,
                      "level_batched": lk_track_pyramid.batched_launches,
                      "pnp_hypotheses": pnp.refine_hypotheses.launches,
                      "pnp_polish": pnp.refine_polish.launches}
    fake = _FakeGraph()
    packed = torch.zeros(3, dtype=torch.uint8)
    cap = cudagraph._Capture(None, fake, packed,
                             {"quad": 3, "level_batched": 32,
                              "pnp_hypotheses": 1, "pnp_polish": 1}, 0.0)
    try:
        for _ in range(5):
            assert cap.replay() is packed
        after = cudagraph.launch_counts()
        assert after["quad"] == before["quad"] + 15
        assert after["level_batched"] == before["level_batched"] + 160
        assert after["pnp_hypotheses"] == before["pnp_hypotheses"] + 5
        assert after["pnp_polish"] == before["pnp_polish"] + 5
        assert after["quad_batched"] == before["quad_batched"]
        assert after["level"] == before["level"]
        assert fake.replays == 5
    finally:
        cudagraph.set_launch_counts(before)
    assert cudagraph.launch_counts() == before


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_scan(cfg, intr, frames, batched, graphed, dev, with_tracks=False):
    lefts, rights = (x.to(dev) for x in _stacks(frames, batched))
    if batched:
        state = batch.batched_init_state(
            cfg, *(np.stack([s[0][k] for s in frames]) for k in (0, 1)),
            seed=3, device=dev)
    else:
        state = pipeline.init_vo_state(cfg, intr, *frames[0][0], seed=3,
                                       device=dev)
    scan = pipeline.make_scan_step_fn(cfg, intr, with_tracks=with_tracks,
                                      device=dev, _graph=graphed)
    state, *a = scan(state, lefts[:2], rights[:2])
    state, *b = scan(state, lefts[2:], rights[2:])
    return state, a + b


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_graphed_scan_equals_eager_on_card(setup, cuda_device, batched):
    """Replays against eager steps on the card: every output, the final
    state and the generators' state, bit for bit; the same launches
    counted."""
    cfg, intr, frames = setup
    runs = {}
    for graphed in (False, True):
        before = cudagraph.launch_counts()
        runs[graphed] = _card_scan(cfg, intr, frames, batched, graphed,
                                   cuda_device)
        after = cudagraph.launch_counts()
        runs[graphed] += ({k: after[k] - before[k] for k in after},)
    (es, eo, ec), (gs, go, gc) = runs[False], runs[True]
    torch.cuda.synchronize()
    assert _same_outputs(eo, go)
    assert all(_equal(x, y) for x, y in zip(cudagraph.state_tensors(es),
                                            cudagraph.state_tensors(gs)))
    assert ec == gc
    lk = ec["quad_batched" if batched else "quad"]
    assert lk == 3 * (N_FRAMES - 1) and sum(ec.values()) == 5 * (N_FRAMES - 1)
    assert ec["pnp_hypotheses"] == ec["pnp_polish"] == N_FRAMES - 1


@pytest.mark.cuda
def test_generator_state_after_replays_equals_eager(setup, cuda_device):
    cfg, intr, frames = setup
    states = [_card_scan(cfg, intr, frames, False, g, cuda_device,
                         with_tracks=True)[0] for g in (False, True)]
    assert torch.equal(states[0].generator.get_state(),
                       states[1].generator.get_state())
    assert int(states[1].generator.get_state().view(torch.int64)[1]) > 0


@pytest.mark.cuda
def test_resume_from_graphed_checkpoint_equals_uninterrupted(
        setup, cuda_device, tmp_path, monkeypatch):
    """A graphed resumable scan that fails after its first snapshot and is
    resumed equals the eager uninterrupted run bit for bit."""
    cfg, intr, frames = setup
    seq = SyntheticStereoSequence(CameraIntrinsics(**INTR), num_frames=9,
                                  seed=0)
    kw = dict(chunk=2, checkpoint_every=4, warmup=False, collect_tracks=True,
              device=cuda_device)
    with monkeypatch.context() as m:
        _eager_scan_fn(m)
        full = pipeline.run_sequence_scan_resumable(
            seq, cfg, intr, str(tmp_path / "full.npz"), **kw)

    class Flaky:
        def __len__(self):
            return len(seq)

        def frame(self, i):
            if i >= 6:
                raise RuntimeError("injected decode failure")
            return seq.frame(i)

    ck = str(tmp_path / "crash.npz")
    with pytest.raises(RuntimeError, match="injected"):
        pipeline.run_sequence_scan_resumable(Flaky(), cfg, intr, ck, **kw)
    resumed = pipeline.run_sequence_scan_resumable(seq, cfg, intr, ck, **kw)
    assert resumed[3] == 4
    np.testing.assert_array_equal(resumed[0], full[0])
    for a, b in zip(resumed[1], full[1]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(resumed[4], full[4]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_capture_that_cannot_proceed_raises(setup, cuda_device):
    """A step that reads a value back to the host cannot be captured: the
    capture raises, and nothing steps eagerly in its place."""
    cfg, intr, frames = setup
    step = pipeline.make_step_fn(cfg, intr, device=cuda_device)

    def syncing_step(state, left, right):
        new, out = step(state, left, right)
        if out.num_inliers.item() < 0:      # a host sync
            raise AssertionError("unreachable")
        return new, out

    graphed = cudagraph.GraphedStep(syncing_step, cuda_device)
    state = pipeline.init_vo_state(cfg, intr, *frames[0][0],
                                   device=cuda_device)
    lefts, rights = (x.to(cuda_device) for x in _stacks(frames, False))
    with pytest.raises(RuntimeError):
        graphed.scan(state, lefts[:1], rights[:1])
    assert not graphed.captures
