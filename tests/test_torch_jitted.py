"""``Trainer.make_jitted`` on the CPU: the chunk of the static-state
stepper equals ``rollout_chunk``'s bit for bit (every field of the state
and the generator's, over two chunks with the drivers' work between them:
``drain_stats`` and the learners' decays; auto-resets from the reset bank;
the learn gate opening inside the first chunk) for TD3 under both tracker
forms, DDPG, SAC and DQN; its buffers keep their addresses; a step with
the gate open reads nothing from the device on the host and copies
nothing from the host (the CPU stand-in for the capture's rule); a no-learn
chunk equals the JAX package's ``Trainer.make_jitted`` chunk; and what it
refuses. On the CPU the stepper runs its steps eagerly (the caller asked
for the CPU); the card's graph is held to the eager chunk by
``chip_smoke.py``'s ``jitted`` phase."""
import contextlib
import dataclasses
import importlib.util
import os
import types
import weakref

import jax
import numpy as np
import pytest
import torch

from crowdnav_tpu.envs import CrowdEnv, make_config
from crowdnav_tpu.parallel import Trainer as JTrainer
from crowdnav_tpu.parallel import TrainerConfig as JTrainerConfig
from crowdnav_tpu_torch.drivers import evaluate as tevaluate
from crowdnav_tpu_torch.drivers import train as ttrain
from crowdnav_tpu_torch.envs import config as tcfg
from crowdnav_tpu_torch.envs.crowd_env import CrowdEnv as TCrowdEnv
from crowdnav_tpu_torch.parallel.mesh import Mesh, ShardedTrainer
from crowdnav_tpu_torch.parallel.runtime import (JittedChunk, Trainer,
                                                 TrainerConfig)
from crowdnav_tpu_torch.utils import numerics as nm
from crowdnav_tpu_torch.utils.tree import named_tensors
from test_torch_evaluate import _GoalSeeker
from torch_parity import assert_env_state_equal, env_state_to_torch

torch.set_num_threads(1)

# 8 envs, chunks of 6 steps, episodes of at most 3 steps (auto-resets from
# a reset bank of 8), the gate opening after the third step's add (24 rows)
BASE = ["--device", "cpu", "--n-envs", "8", "--chunk", "6",
        "--updates-per-step", "2", "--batch-size", "16", "--learn-start",
        "24", "--max-steps", "3", "--jitter", "1.0", "--reset-bank", "8",
        "--buffer-size", "64", "--seed", "0"]
SIMPLE = ["--world", "crowd_sparse", "--behavior", "random"]
CASES = {
    "td3_xla": ["--algo", "td3", "--replay-obs-dtype", "bfloat16",
                "--explore-eps", "1.0", "--explore-eps-min", "0.05",
                "--explore-spectrum", "--sigma-min", "0.1",
                "--sigma-decay-steps", "96"],
    "td3_pallas": ["--algo", "td3", "--risk-backend", "pallas",
                   "--sigma-min", "0.1", "--sigma-decay-steps", "96"],
    "ddpg": ["--algo", "ddpg"],
    "sac": ["--algo", "sac", *SIMPLE],
    "dqn": ["--algo", "dqn", *SIMPLE],
}


def _trainer(case) -> Trainer:
    return ttrain.build(ttrain.parser().parse_args(BASE + CASES[case]))


def _between(trainer, state, chunk):
    """The drivers' work between two chunks: the drained statistics, the
    DQN's epsilon decay and TD3's sigma anneal."""
    summary, state = trainer.drain_stats(state)
    agent = trainer.agent
    if hasattr(agent, "decay_epsilon"):
        state = dataclasses.replace(
            state, agent_state=agent.decay_epsilon(state.agent_state))
    if hasattr(agent, "decay_sigma"):
        steps = (chunk + 1) * trainer.tcfg.n_envs * trainer.tcfg.rollout_chunk
        state = dataclasses.replace(state, agent_state=agent.decay_sigma(
            state.agent_state, steps))
    return summary, state


def _bits(t):
    return t.detach().reshape(-1).contiguous().view(torch.uint8)


def _assert_states_equal(got, want):
    g, w = dict(named_tensors(got)), dict(named_tensors(want))
    assert set(g) == set(w)
    for name in w:
        assert g[name].dtype == w[name].dtype, name
        assert g[name].shape == w[name].shape, name
        assert torch.equal(_bits(g[name]), _bits(w[name])), name
    assert torch.equal(got.gen.get_state(), want.gen.get_state())
    assert got.learning_open == want.learning_open


@pytest.mark.parametrize("case", list(CASES))
def test_jitted_chunk_equals_rollout_chunk(case):
    trainer = _trainer(case)
    eager = trainer.init(0)
    run = trainer.make_jitted()
    graph = trainer.init(0)
    assert isinstance(run, JittedChunk)
    for chunk in range(2):
        eager = trainer.rollout_chunk(eager)
        graph = run(graph)
        if chunk == 0:
            # the gate opened inside the first chunk, after a shut step
            assert graph.learning_open and eager.learning_open
        _assert_states_equal(graph, eager)
        got, graph = _between(trainer, graph, chunk)
        want, eager = _between(trainer, eager, chunk)
        assert got == want
        assert want["episodes"] > 0
    _assert_states_equal(run(graph), trainer.rollout_chunk(eager))
    assert int(eager.replay.size) == trainer.buffer.capacity   # wrapped
    # a restart (the drivers' collapse restart): another seed's fresh
    # state, its own generator, the gate shut again
    graph = run(trainer.init(7))
    _assert_states_equal(graph, trainer.rollout_chunk(trainer.init(7)))


def test_jitted_state_keeps_its_addresses():
    trainer = _trainer("td3_xla")
    run = trainer.make_jitted()
    state = trainer.init(0)
    ring = state.replay.obs.data_ptr()
    state = run(state)
    assert state.replay.obs.data_ptr() == ring      # adopted, not copied
    ptrs = {k: t.data_ptr() for k, t in named_tensors(state)}
    static = state
    for chunk in range(2):
        _, state = _between(trainer, state, chunk)
        state = run(state)
        assert state is static
        assert {k: t.data_ptr() for k, t in named_tensors(state)} == ptrs


_HOST_READS = {
    torch.Tensor: ("item", "__bool__", "__int__", "__float__",
                   "__index__", "tolist", "numpy", "cpu", "nonzero"),
    torch: ("nonzero", "tensor", "as_tensor", "from_numpy")}


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    """Every host read of a tensor, every tensor made from host data and
    every ``Tensor.to`` that names a device raises, except inside the CPU
    stand-in of the C-library trig kernel (``nm._libm_map``, which is the
    C library itself on the host)."""
    allowed = [False]

    def guard(owner, name):
        orig = getattr(owner, name)

        def guarded(*a, **kw):
            if not allowed[0]:
                raise AssertionError(f"host read in the step: {name}")
            return orig(*a, **kw)
        monkeypatch.setattr(owner, name, guarded)

    libm_map = nm._libm_map

    def stand_in(*a, **kw):
        allowed[0] = True
        try:
            return libm_map(*a, **kw)
        finally:
            allowed[0] = False

    for owner, names in _HOST_READS.items():
        for name in names:
            guard(owner, name)
    to = torch.Tensor.to

    def to_device(self, *a, **kw):
        # a device named is a copy between host and card on the card
        if not allowed[0] and ("device" in kw or any(
                isinstance(x, (torch.device, str)) for x in a)):
            raise AssertionError(f"host copy in the step: to{a}")
        return to(self, *a, **kw)
    monkeypatch.setattr(torch.Tensor, "to", to_device)
    monkeypatch.setattr(nm, "_libm_map", stand_in)
    yield
    monkeypatch.undo()


@pytest.mark.parametrize("case", [*CASES, "td3_no_learn"])
def test_open_gate_step_reads_nothing_on_the_host(case, monkeypatch):
    learning = case != "td3_no_learn"
    trainer = ttrain.build(ttrain.parser().parse_args(
        BASE + CASES[case if learning else "td3_xla"]), learning=learning)
    run = trainer.make_jitted()
    state = run(trainer.init(0))
    assert state.learning_open == learning
    before = state.agent_state
    with _no_host_reads(monkeypatch):
        state = run(state)
        with pytest.raises(AssertionError, match="host read"):
            state.obs.sum().item()
    assert state.agent_state is before     # updated in place
    if learning:
        assert int(state.replay.size) == trainer.buffer.capacity


def test_no_learn_chunk_equals_the_jax_jitted_chunk():
    """From the JAX package's initial state, carried over through numpy,
    with a policy both frameworks compute bit for bit and the template
    auto-reset (no draws in the chunk)."""
    n, chunk = 8, 40
    kw = dict(jitter=1.0, max_steps=16)
    jenv = CrowdEnv(make_config("crowd_dense", "crossing", **kw))
    jt = JTrainer(jenv, _GoalSeeker(), JTrainerConfig(
        n_envs=n, rollout_chunk=chunk, learning=False))
    j0 = jt.init(jax.random.PRNGKey(0))
    tenv = TCrowdEnv(tcfg.make_config("crowd_dense", "crossing", **kw),
                     device="cpu")
    st, obs = jenv._template
    tenv.template = (env_state_to_torch(jax.tree.map(lambda a: a[None], st)),
                     torch.from_numpy(np.array(obs))[None])
    tt = Trainer(tenv, _GoalSeeker(), TrainerConfig(
        n_envs=n, rollout_chunk=chunk, learning=False))
    ts = dataclasses.replace(
        tt.init(0), env_states=env_state_to_torch(j0.env_states),
        obs=torch.from_numpy(np.array(j0.obs)))
    js = jt.make_jitted()(j0)
    ts = tt.make_jitted()(ts)
    assert_env_state_equal(ts.env_states, js.env_states)
    np.testing.assert_array_equal(ts.obs.numpy(), np.asarray(js.obs))
    for f in dataclasses.fields(ts.stats):
        np.testing.assert_array_equal(
            getattr(ts.stats, f.name).numpy(),
            np.asarray(getattr(js.stats, f.name)), err_msg=f.name)
    assert int(ts.stats.episodes) > n


def test_make_jitted_refuses():
    trainer = _trainer("td3_xla")
    trainer.spans = []
    with pytest.raises(ValueError, match="spans"):
        trainer.make_jitted()
    trainer.spans = None
    run = trainer.make_jitted()
    trainer.spans = []
    with pytest.raises(ValueError, match="spans"):
        run(trainer.init(0))
    trainer.spans = None
    state = run(trainer.init(0))
    other = trainer.init(1)
    other.stats.ep_reward = other.stats.ep_reward[:4]
    with pytest.raises(ValueError, match="ep_reward"):
        run(other)
    other = trainer.init(1)
    other.learn_metrics = None
    with pytest.raises(ValueError, match="changed"):
        run(other)
    assert run(state) is state


def test_make_jitted_on_a_cuda_trainer_without_a_card_raises(monkeypatch):
    trainer = _trainer("td3_xla")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trainer.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.make_jitted()


def test_sharded_make_jitted_is_not_ported():
    args = ttrain.parser().parse_args(BASE + CASES["td3_xla"])
    flat = ttrain.build(args)
    sharded = ShardedTrainer(flat.env, flat.agent, flat.tcfg,
                             Mesh(size=1, rank=0))
    with pytest.raises(NotImplementedError, match="NCCL"):
        sharded.make_jitted()


def _spy(monkeypatch):
    made = []
    orig = Trainer.make_jitted

    def spy(self):
        made.append(self)
        return orig(self)
    monkeypatch.setattr(Trainer, "make_jitted", spy)
    return made


def test_drivers_run_their_chunks_through_make_jitted(tmp_path, monkeypatch,
                                                      capsys):
    made = _spy(monkeypatch)
    ttrain.main(BASE + CASES["td3_xla"] + [
        "--env-steps", "96", "--outdir", str(tmp_path)])
    assert len(made) == 1 and made[0].tcfg.learning
    made.clear()
    results = tevaluate.main([
        "--device", "cpu", "--suite", "train", "--n-envs", "4",
        "--max-steps", "6", "--outdir", str(tmp_path)])
    assert len(made) == 1 and not made[0].tcfg.learning
    assert results[0]["episodes"] >= 0
    capsys.readouterr()


def test_collapse_restart_frees_the_chunk_before_the_next(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """A collapse restart drops the chunk, its buffers and their replay
    ring, before ``Trainer.init`` makes the next state, and runs the next
    attempt through a chunk of its own."""
    chunks, alive_at_init = [], []
    make, init = Trainer.make_jitted, Trainer.init

    def spy_make(self):
        run = make(self)
        chunks.append(weakref.ref(run))
        return run

    def spy_init(self, seed):
        alive_at_init.append(sum(r() is not None for r in chunks))
        return init(self, seed)
    monkeypatch.setattr(Trainer, "make_jitted", spy_make)
    monkeypatch.setattr(Trainer, "init", spy_init)
    ttrain.main(BASE + CASES["td3_xla"] + [
        "--env-steps", "96", "--outdir", str(tmp_path),
        "--restart-on-collapse", "1", "--collapse-detect-chunk", "1",
        "--collapse-reward-threshold", "1e9"])
    restarts = [e for e in capsys.readouterr().out.splitlines()
                if '"collapse_restart"' in e]
    assert len(restarts) == 1
    assert len(chunks) == 2
    assert alive_at_init == [0, 0]


def _script(path, name):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kernel_events_name_each_kernel_form():
    """``chip_smoke.py`` counts the launches of a graph's replays by the
    kernels' demangled names: each form of the raycast
    <beams a thread, Pallas> and of the tracker <S, T, K, form> apart, the
    trig kernels apart from PyTorch's own atan2, and a name of the port's
    kernels that no form matches raises."""
    cs = _script("chip_smoke.py", "chip_smoke")
    ns = "void (anonymous namespace)::"
    names = [
        ns + "raycast_kernel<8, false>(float2 const*, float const*)",
        ns + "raycast_kernel<4, false>(float2 const*, float const*)",
        ns + "raycast_kernel<2, true>(float2 const*, float const*)",
        ns + "track_cp_topk_kernel<32, 24, 8, 0>((anonymous namespace)"
        "::Ptrs, int, int, int, int, (anonymous namespace)::Consts)",
        ns + "track_cp_topk_kernel<32, 24, 1, 1>((anonymous namespace)"
        "::Ptrs, int, int, int, int, (anonymous namespace)::Consts)",
        ns + "track_cp_topk_kernel<32, 24, 8, 2>((anonymous namespace)"
        "::Ptrs, int, int, int, int, (anonymous namespace)::Consts)",
        ns + "sincos_kernel(float const*, float*, int, int)",
        ns + "sincos_kernel(float const*, float*, int, int)",
        ns + "atan2_kernel(float const*, float const*, float*, int)",
        "void at::native::vectorized_elementwise_kernel<4, at::native::"
        "atan2_kernel_cuda(at::TensorIteratorBase&)::{lambda()#1}>(int)",
        "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x128x8"]
    card = [types.SimpleNamespace(name=n) for n in names]
    assert cs.kernel_events(card) == {
        "raycast": 2, "raycast_pallas": 1, "track_cp_topk": 1,
        "track_cp_topk_strict": 1, "track_cp_topk_pallas": 1,
        "libm_sincos": 2, "libm_atan2": 1}
    with pytest.raises(AssertionError, match="raycast_kernel"):
        cs.kernel_events([types.SimpleNamespace(
            name=ns + "raycast_kernel<8, (bool)1>(float)")])


@pytest.mark.parametrize("lost", [0, 2, 4])
def test_marked_window_keeps_the_records_between_its_markers(lost,
                                                              monkeypatch):
    """``bench_torch_train.marked_window`` (``chip_smoke.py``'s profiler
    windows) counts the card's records between its two marker kernels
    only: records the profiler lost at the window's start (here the
    first ``lost``) fall in the uncounted call before the first marker,
    and a lost marker raises."""
    bt = _script(os.path.join("scripts", "bench_torch_train.py"),
                 "bench_torch_train")
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    log = []

    def record(name, device=cuda):
        t = float(len(log))
        log.append(types.SimpleNamespace(
            name=name, device_type=device,
            time_range=types.SimpleNamespace(start=t, end=t + 0.5)))

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            log.clear()
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return list(reversed(log[lost:]))

    def step():
        record("aten::mm", cpu)
        record("void (anonymous namespace)::raycast_kernel<8, false>(int)")
        record("sm90_xmma_gemm")

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: record(
        "at::cuda::(anonymous namespace)::spin_kernel(long)"))
    monkeypatch.setattr(bt.time, "sleep", lambda s: None)
    if lost == 4:
        with pytest.raises(RuntimeError, match="1 of its 2 marker"):
            bt.marked_window(torch, step, 3, [])
        return
    _, card, _ = bt.marked_window(torch, step, 3, [])
    assert [e.name for e in card] == [
        "void (anonymous namespace)::raycast_kernel<8, false>(int)",
        "sm90_xmma_gemm"] * 3
