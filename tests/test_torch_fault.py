"""Port vs JAX package on the CPU: ``parallel/fault.py``'s checkpoint
manager, distributed checkpoints and gang supervision.

tests/test_fault.py's checkpoint cases run on the port (rotation and
atomicity, a corrupt newest file skipped, temporary files never taken,
foreign files ignored, the supervisor giving up after ``max_restarts``).
A small config-4 chain killed before block 4 by a torch-only worker
(tests/torch_fault_worker.py) and relaunched by ``run_supervised``
resumes bit-identically; two gloo ranks killed and gang-restarted resume
from ``latest_distributed_step`` through ``load_distributed``, each rank
checking its chunks bit-equal to an uninterrupted run.  A one-process
checkpoint written by JAX's ``save_distributed`` loads in the port, and
the reverse, leaf for leaf.  Each subprocess gang is limited to 120 s.
"""

import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solid_dsp_tpu.models.rx_chain import RxChainConfig as JaxConfig
from solid_dsp_tpu.models.rx_chain import make_rx_chain as jax_make_rx_chain
from solid_dsp_tpu.parallel import fault as jfault
from solid_dsp_tpu_torch.interop import state_to_numpy
from solid_dsp_tpu_torch.models.rx_chain import RxChainConfig, make_rx_chain
from solid_dsp_tpu_torch.parallel import fault
from solid_dsp_tpu_torch.parallel.fault import (CheckpointManager,
                                                SupervisorError,
                                                run_supervised)
from solid_dsp_tpu_torch.streaming.state import ChainState
from torch_parity import CONFIG4, make_blocks

WORKER = os.path.join(os.path.dirname(__file__), "torch_fault_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT_S = 120.0


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH")}
    env["PYTHONPATH"] = REPO
    return env


def test_public_names_match_jax():
    assert set(fault.__all__) == set(jfault.__all__)
    from solid_dsp_tpu_torch import parallel
    for name in fault.__all__:
        assert getattr(parallel, name) is getattr(fault, name)


def test_checkpoint_manager_rotation_and_atomicity(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    st = ChainState(x=torch.arange(4.0), g={"v": torch.tensor(1.5)})
    for i in range(5):
        cm.save(st.replace(x=torch.arange(4.0) + i), i)
    files = sorted(glob.glob(str(tmp_path / "ckpt_*.npz")))
    assert len(files) == 2
    assert [os.path.basename(f) for f in files] == [
        "ckpt_000000000003.npz", "ckpt_000000000004.npz"]
    got, nxt = cm.latest(like=st)
    assert nxt == 5
    np.testing.assert_array_equal(got.x.numpy(), np.arange(4.0) + 4)
    assert float(got.g["v"]) == 1.5


def test_checkpoint_manager_empty_and_keep_floor(tmp_path):
    cm = CheckpointManager(str(tmp_path / "new"), keep=0)
    assert cm.keep == 1
    assert cm.latest(like=ChainState(x=torch.zeros(2))) == (None, 0)


def test_checkpoint_manager_skips_corrupt_latest(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=3)
    st = ChainState(x=torch.arange(3.0))
    cm.save(st, 0)
    cm.save(st.replace(x=torch.arange(3.0) * 2), 1)
    newest = sorted(os.listdir(tmp_path))[-1]
    with open(os.path.join(tmp_path, newest), "wb") as f:
        f.write(b"garbage")
    got, nxt = cm.latest(like=st)
    assert nxt == 1
    np.testing.assert_array_equal(got.x.numpy(), np.arange(3.0))


def test_checkpoint_manager_skips_structure_drift(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=3)
    cm.save(ChainState(x=torch.arange(3.0)), 0)
    cm.save(ChainState(x=torch.arange(3.0), y=torch.zeros(1)), 1)
    got, nxt = cm.latest(like=ChainState(x=torch.zeros(3)))
    assert nxt == 1
    np.testing.assert_array_equal(got.x.numpy(), np.arange(3.0))


def test_checkpoint_tmp_files_never_poison_recovery(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    st = ChainState(x=torch.arange(3.0))
    cm.save(st, 0)
    stray = os.path.join(str(tmp_path), ".tmp_ckpt_000000000001.npz")
    with open(stray, "wb") as f:
        f.write(b"torn")
    got, nxt = cm.latest(like=st)
    assert nxt == 1
    cm.save(st, 1)
    assert not glob.glob(os.path.join(str(tmp_path), ".tmp_*"))


def test_checkpoint_manager_reads_jax_checkpoints(tmp_path):
    """A JAX CheckpointManager's files resume a port chain, and the
    reverse: each package's manager takes the other's newest file."""
    init_j, apply_j = jax_make_rx_chain(JaxConfig(**CONFIG4,
                                                  dtype=jnp.complex64))
    blocks = make_blocks(2, L=8192, seed=5)
    _, sj = apply_j(init_j(), jnp.asarray(blocks[0]))
    jfault.CheckpointManager(str(tmp_path / "j")).save(sj, 0)
    init, _ = make_rx_chain(RxChainConfig(**CONFIG4), "cpu")
    got, nxt = CheckpointManager(str(tmp_path / "j")).latest(like=init())
    assert nxt == 1
    want = jax.tree_util.tree_map(np.asarray, sj)
    np.testing.assert_array_equal(state_to_numpy(got)["fir_tail"],
                                  want["fir_tail"])
    CheckpointManager(str(tmp_path / "t")).save(got, 7)
    back, nxt = jfault.CheckpointManager(str(tmp_path / "t")).latest(
        like=init_j())
    assert nxt == 8
    assert int(back["nco_theta"]) == int(want["nco_theta"])


def test_supervisor_gives_up_after_max_restarts():
    starts = []

    def spawn(worker_id, attempt):
        starts.append((worker_id, attempt))
        return subprocess.Popen([sys.executable, "-c",
                                 "import sys; sys.exit(3)"],
                                stdout=subprocess.PIPE, text=True)

    with pytest.raises(SupervisorError, match="failed after 2 attempts"):
        run_supervised(spawn, num_workers=1, max_restarts=1, timeout=60.0)
    assert starts == [(0, 0), (0, 1)]


def test_supervisor_times_out_and_kills():
    procs = []

    def spawn(worker_id, attempt):
        p = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(60)"])
        procs.append(p)
        return p

    with pytest.raises(SupervisorError, match="timeout"):
        run_supervised(spawn, num_workers=2, timeout=1.0,
                       poll_interval=0.05)
    for p in procs:
        assert p.wait(timeout=10) is not None


def test_latest_distributed_step_ignores_temp_and_foreign_files(tmp_path):
    d = str(tmp_path)
    open(os.path.join(d, "step_000000000003_proc0.npz"), "wb").close()
    open(os.path.join(d, ".tmp_step_000000000005_proc0.npz"), "wb").close()
    open(os.path.join(d, "step_000000000004_proc0.npz.bak"), "wb").close()
    assert fault.latest_distributed_step(d) == 3
    assert fault.latest_distributed_step(d) == \
        jfault.latest_distributed_step(d)
    assert fault.latest_distributed_step(str(tmp_path / "none")) == -1


def _run_chain_gang(out_dir, crash: bool):
    crash_flag = os.path.join(out_dir, "crash_once")
    if crash:
        open(crash_flag, "w").close()
    logs = []

    def spawn(worker_id, attempt):
        p = subprocess.Popen(
            [sys.executable, WORKER, "chain", out_dir, crash_flag, "cpu",
             "4096"], env=_env(), cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        logs.append(p)
        return p

    codes = run_supervised(spawn, num_workers=1, max_restarts=2,
                           timeout=GANG_TIMEOUT_S)
    return codes, [p.stdout.read() for p in logs]


def test_crash_resume_bit_identical(tmp_path):
    clean, crashed = str(tmp_path / "clean"), str(tmp_path / "crashed")
    os.makedirs(clean)
    os.makedirs(crashed)
    codes, logs = _run_chain_gang(clean, crash=False)
    assert codes == [0], logs
    codes, logs = _run_chain_gang(crashed, crash=True)
    assert codes == [0], logs
    assert len(logs) == 2 and "resumed at block 4" in logs[1], logs
    for i in range(8):
        a = np.load(os.path.join(clean, f"block_{i}.npy"))
        b = np.load(os.path.join(crashed, f"block_{i}.npy"))
        np.testing.assert_array_equal(a, b, err_msg=f"block {i}")
    # the worker's blocks are the chain's: the same as a run in process
    import torch_fault_worker as w
    init, apply = make_rx_chain(RxChainConfig(**CONFIG4), "cpu")
    st = init()
    for i, xb in enumerate(w.make_blocks(123, 8, 4096)):
        out, st = apply(st, torch.from_numpy(xb))
        np.testing.assert_array_equal(
            out.numpy(), np.load(os.path.join(clean, f"block_{i}.npy")))


def test_distributed_crash_gang_restart(tmp_path):
    """Two gloo ranks; rank 1 dies before chunk 2; the supervisor restarts
    both, which resume from the newest step both ranks wrote."""
    out_dir = str(tmp_path)
    crash_flag = os.path.join(out_dir, "crash_once")
    open(crash_flag, "w").close()
    logs = []

    def spawn(worker_id, attempt):
        p = subprocess.Popen(
            [sys.executable, WORKER, "dist", str(worker_id), "2",
             os.path.join(out_dir, f"store{attempt}"), out_dir, crash_flag],
            env=_env(), cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        logs.append(p)
        return p

    codes = run_supervised(spawn, num_workers=2, max_restarts=2,
                           timeout=GANG_TIMEOUT_S)
    out = [p.stdout.read() for p in logs]
    assert codes == [0, 0], out
    assert not os.path.exists(crash_flag)
    assert len(logs) == 4, out
    assert "rank0: start at chunk 2" in out[2], out
    assert "rank1: start at chunk 2" in out[3], out
    for r in (0, 1):
        assert os.path.exists(os.path.join(out_dir, f"PASS_rank{r}"))
    ck = os.path.join(out_dir, "dckpts")
    with np.load(os.path.join(ck, "step_000000000003_proc1.npz")) as data:
        keys = sorted(k for k in data.files if k.startswith("leaf"))
        assert keys[0] == "leaf0_dev1" and len(keys) == 9


def _jax_state():
    init_j, apply_j = jax_make_rx_chain(JaxConfig(**CONFIG4,
                                                  dtype=jnp.complex64))
    _, sj = apply_j(init_j(), jnp.asarray(make_blocks(1, L=8192,
                                                      seed=8)[0]))
    return init_j, sj


def _assert_same_leaves(port_state, jax_state):
    got = jax.tree_util.tree_leaves(state_to_numpy(port_state))
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                            jax_state))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_jax_distributed_checkpoint_loads_in_port(tmp_path):
    _, sj = _jax_state()
    path = jfault.save_distributed(sj, str(tmp_path), 3)
    assert os.path.basename(path) == "step_000000000003_proc0.npz"
    assert fault.latest_distributed_step(str(tmp_path)) == 3
    init, _ = make_rx_chain(RxChainConfig(**CONFIG4), "cpu")
    got = fault.load_distributed(str(tmp_path), 3, like=init())
    assert isinstance(got, ChainState)
    assert got["nco_theta"].dtype == torch.int64
    _assert_same_leaves(got, sj)


def test_port_distributed_checkpoint_loads_in_jax(tmp_path):
    init_j, sj = _jax_state()
    init, apply = make_rx_chain(RxChainConfig(**CONFIG4), "cpu")
    _, st = apply(init(), torch.from_numpy(make_blocks(1, L=8192,
                                                       seed=8)[0]))
    path = fault.save_distributed(st, str(tmp_path), 5)
    with np.load(path) as data:
        assert sorted(data.files)[:2] == ["__treedef__", "__version__"]
        assert "leaf0_dev0" in data.files
    assert jfault.latest_distributed_step(str(tmp_path)) == 5
    back = jfault.load_distributed(str(tmp_path), 5, like=init_j())
    _assert_same_leaves(st, back)


def test_load_distributed_checks_structure_leaves_and_version(tmp_path):
    d = str(tmp_path)
    st = ChainState(x=torch.arange(4.0), g={"v": torch.tensor(1.5)})
    fault.save_distributed(st, d, 0)
    got = fault.load_distributed(d, 0, like=st)
    np.testing.assert_array_equal(got.x.numpy(), np.arange(4.0))
    with pytest.raises(ValueError, match="structure mismatch"):
        fault.load_distributed(d, 0, like=ChainState(x=torch.zeros(4)))
    with pytest.raises(ValueError, match="leaf 1"):
        fault.load_distributed(d, 0, like=st.replace(x=torch.zeros(5)))
    with pytest.raises(ValueError, match="leaf 0"):
        fault.load_distributed(d, 0, like=st.replace(
            g={"v": torch.tensor(1.5, dtype=torch.float64)}))
    path = os.path.join(d, "step_000000000000_proc0.npz")
    data = dict(np.load(path).items())
    data["__version__"] = np.asarray(ChainState.CHECKPOINT_VERSION + 1)
    np.savez(path, **data)
    with pytest.raises(ValueError, match="newer"):
        fault.load_distributed(d, 0, like=st)
