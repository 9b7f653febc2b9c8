"""The port's run supervision (`nsc_tpu_torch/train/watchdog.py`, the
counterpart of `scripts/train_watchdog.sh`) and its harvest sidecar
(`nsc_tpu_torch/train/harvest.py`, of `scripts/harvest_checkpoints.sh`).

The watchdog runs a fake trainer (a small script that plays one entry of a
plan per launch: metrics rows, a liveness marker, a hang, an exit code) at
polls of 0.05 s, and once the real entry point on `tiny_test` on the CPU,
SIGKILLed after its first full save. The harvester runs on small fake
exports (`checkpoint.save_inference` of two arrays)."""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from nsc_tpu_torch.train import checkpoint as ckpt
from nsc_tpu_torch.train import harvest
from nsc_tpu_torch.train import watchdog as W
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLL = 0.05

FAKE_TRAINER = r'''
import json, os, sys, time
plan = json.load(open(sys.argv[1]))
args = sys.argv[2:]
wd = args[args.index("--workdir") + 1]
seen = os.path.join(wd, "launches.jsonl")
n = sum(1 for _ in open(seen)) if os.path.exists(seen) else 0
act = plan[min(n, len(plan) - 1)]
found = sorted(os.path.relpath(os.path.join(d, x), wd) for sub in ("train", "infer", "infer_best")
               for d, dirs, files in os.walk(os.path.join(wd, sub)) for x in dirs + files)
with open(seen, "a") as f:
    f.write(json.dumps({"pid": os.getpid(), "t": time.time(), "found": found, "args": args}) + "\n")
if act.get("marker"):
    print("NSC-LIVENESS: DEVICE WEDGED: the probe did not answer", flush=True)
for s in act.get("rows", []):
    with open(os.path.join(wd, "metrics.jsonl"), "a") as f:
        f.write(json.dumps({"step": s, "loss/mel": 1.0}) + "\n")
if act.get("hang"):
    time.sleep(600)
sys.exit(act.get("rc", 0))
'''


@pytest.fixture
def fake(tmp_path, monkeypatch):
    """supervise() of tmp_path/run with the fake trainer and a plan;
    returns (result, launches, the backoff sleeps it asked for). Each
    launch's "launched_at" is the clock just after the supervisor's Popen
    returned (its own launch time is taken right after that), so the gap
    between two launches is the supervisor's, not that of the two fakes'
    interpreter start-ups, which vary under load."""
    script = tmp_path / "fake_trainer.py"
    script.write_text(FAKE_TRAINER)
    procs = []
    popen, launched_at = subprocess.Popen, {}

    def timed_popen(*a, **kw):
        proc = popen(*a, **kw)
        launched_at[proc.pid] = time.time()
        return proc

    monkeypatch.setattr(W.subprocess, "Popen", timed_popen)

    def run(plan, args=(), **kw):
        plan_path = tmp_path / "plan.json"
        plan_path.write_text(json.dumps(plan))
        sleeps = []

        def sleep(s):
            sleeps.append(s)
            time.sleep(s)

        opts = dict(poll=POLL, grace_s=60.0, stale_s=60.0, wedge_backoff_s=0.1,
                    pid_file=str(tmp_path / "train.pid"), stop_file=str(tmp_path / "stop"),
                    sleep=sleep)
        opts.update(kw)
        res = W.supervise(str(tmp_path / "run"), list(args),
                          command=[sys.executable, str(script), str(plan_path)], **opts)
        procs.append(res.proc)
        with open(tmp_path / "run" / "launches.jsonl") as f:
            launches = [json.loads(line) for line in f]
        for launch in launches:
            launch["launched_at"] = launched_at[launch["pid"]]
        return res, launches, [s for s in sleeps if s != POLL]

    yield run
    for p in procs:
        if p is not None and p.poll() is None:
            p.kill()
            p.wait(10)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # a zombie of the Popen object counts as gone
    with open(f"/proc/{pid}/stat") as f:
        return f.read().split(")")[-1].split()[0] != "Z"


def test_rc0_is_a_complete_run(fake, tmp_path):
    res, launches, backoffs = fake([{"rows": [1], "rc": 0}])
    assert (res.status, res.restarts, len(launches), backoffs) == ("complete", 0, 1, [])
    assert "process exited 0 -> run complete" in res.events[-1]
    assert (tmp_path / "train.pid").read_text().strip() == str(launches[0]["pid"])
    assert (tmp_path / "run.watchdog.log").read_text().splitlines() == res.events
    assert launches[0]["args"][:2] == ["--workdir", str(tmp_path / "run")]


@pytest.mark.parametrize("rc", [1, 97, 98, 99])
def test_a_crash_or_a_liveness_exit_means_one_restart(fake, rc):
    res, launches, backoffs = fake([{"rows": [1], "rc": rc}, {"rows": [2], "rc": 0}])
    assert (res.status, res.restarts, len(launches), backoffs) == ("complete", 1, 2, [])
    assert any(f"process gone (rc={rc}) -> restart" in e for e in res.events)


def test_a_killed_trainer_is_restarted(fake, tmp_path):
    pid_file = tmp_path / "train.pid"

    def kill_first():
        while not pid_file.exists():
            time.sleep(0.01)
        time.sleep(0.3)
        os.kill(int(pid_file.read_text()), signal.SIGKILL)

    t = threading.Thread(target=kill_first, daemon=True)
    t.start()
    res, launches, _ = fake([{"rows": [1], "hang": True}, {"rows": [2], "rc": 0}])
    t.join(10)
    assert (res.status, res.restarts, len(launches)) == ("complete", 1, 2)
    assert any(f"process gone (rc={-signal.SIGKILL}) -> restart" in e for e in res.events)


def _after_the_launch_row(tmp_path):
    """A sleep for supervise() that first waits (up to 60 s) until the
    trainer of the PID file has logged its launch and written its row: the
    fake trainer's start-up (an interpreter, under a loaded machine) can
    outlast a short grace, and a trainer killed as stale before it wrote
    its row plays its plan entry again."""
    run, pid_file = tmp_path / "run", tmp_path / "train.pid"

    def rows(name):
        with open(run / name) as f:
            return [json.loads(line) for line in f]

    def sleep(s):
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                pid, launched = int(pid_file.read_text()), rows("launches.jsonl")
                if launched[-1]["pid"] == pid and len(rows("metrics.jsonl")) >= len(launched):
                    break
            except (OSError, ValueError, IndexError):  # not there yet, or a line being written
                pass
            time.sleep(0.01)
        time.sleep(s)

    return sleep


def test_stale_metrics_mean_kill_and_relaunch(fake, tmp_path):
    res, launches, _ = fake([{"rows": [1], "hang": True}, {"rows": [2], "rc": 0}],
                            grace_s=0.2, stale_s=1.0, sleep=_after_the_launch_row(tmp_path))
    assert (res.status, res.restarts, len(launches)) == ("complete", 1, 2)
    assert any("-> restart" in e and "stale" in e for e in res.events)
    assert not _alive(launches[0]["pid"])


def test_no_stale_kill_within_the_grace(fake):
    # no row at all: stale from the start, but killed only once the grace is over
    res, launches, _ = fake([{"hang": True}, {"rows": [1], "rc": 0}], grace_s=0.6, stale_s=0.1)
    assert (res.status, res.restarts, len(launches)) == ("complete", 1, 2)
    assert launches[1]["launched_at"] - launches[0]["launched_at"] >= 0.6


def test_the_last_row_at_steps_means_complete(fake):
    res, launches, _ = fake([{"rows": [1, 2, 3], "hang": True}], args=["--steps", "3"])
    assert (res.status, res.restarts, len(launches)) == ("complete", 0, 1)
    assert res.events[-1].endswith("run complete")
    assert res.proc.poll() is None  # as the JAX supervisor, it leaves the trainer to finish


def test_the_stop_file_ends_supervision_and_leaves_the_trainer(fake, tmp_path):
    stop = tmp_path / "stop"

    def touch():
        time.sleep(0.4)
        stop.touch()

    t = threading.Thread(target=touch, daemon=True)
    t.start()
    res, launches, _ = fake([{"hang": True}])
    t.join(10)
    assert (res.status, res.restarts, len(launches)) == ("stopped", 0, 1)
    assert res.events[-1].endswith("stop file -> exit")
    assert res.proc.poll() is None


def test_a_stale_stop_file_is_cleared_at_start(fake, tmp_path):
    (tmp_path / "stop").touch()
    res, launches, _ = fake([{"rows": [1], "rc": 0}])
    assert (res.status, len(launches)) == ("complete", 1)
    assert not (tmp_path / "stop").exists()


def test_the_wedged_marker_means_backoff(fake):
    res, launches, backoffs = fake([{"marker": True, "rc": 97}, {"rows": [1], "rc": 0}],
                                   wedge_backoff_s=0.3)
    assert (res.status, res.restarts, len(launches), backoffs) == ("complete", 1, 2, [0.3])
    assert any("wedge suspected (fruitless=1) -> backoff 0.3s" in e for e in res.events)
    assert launches[1]["launched_at"] - launches[0]["launched_at"] >= 0.3


def test_two_fruitless_restarts_mean_growing_backoff(fake):
    # no launch writes a row until the fourth: restarts 2 and 3 are fruitless
    plan = [{"rc": 1}, {"rc": 1}, {"rc": 1}, {"rows": [1], "rc": 0}]
    res, launches, backoffs = fake(plan, wedge_backoff_s=0.1)
    assert (res.status, res.restarts, len(launches)) == ("complete", 3, 4)
    assert backoffs == [pytest.approx(0.2), pytest.approx(0.3)]
    assert [e.split(" ", 2)[2] for e in res.events if "wedge" in e] == [
        "wedge suspected (fruitless=2) -> backoff 0.2s",
        "wedge suspected (fruitless=3) -> backoff 0.3s"]


def test_progress_resets_the_fruitless_count(fake):
    plan = [{"rc": 1}, {"rows": [1], "rc": 1}, {"rc": 1}, {"rows": [2], "rc": 0}]
    res, launches, backoffs = fake(plan)
    assert (res.status, res.restarts, len(launches), backoffs) == ("complete", 3, 4, [])


def test_the_stop_file_during_a_backoff_ends_supervision(fake, tmp_path):
    stop = tmp_path / "stop"

    def touch():
        time.sleep(0.6)
        stop.touch()

    t = threading.Thread(target=touch, daemon=True)
    t.start()
    res, launches, backoffs = fake([{"marker": True, "rc": 97}], wedge_backoff_s=2.0)
    t.join(10)
    assert (res.status, len(launches), backoffs) == ("stopped", 1, [2.0])


def test_leftovers_are_removed_before_each_launch(fake, tmp_path):
    run = tmp_path / "run"
    keep = ["train/ckpt_000000002.pt", "infer/2/weights.npz", "infer_best/2/weights.npz"]
    drop = ["train/ckpt_000000003.pt.tmp", "infer/3.tmp/weights.npz",
            "infer_best/3.tmp/meta.json"]
    for rel in keep + drop:
        (run / rel).parent.mkdir(parents=True, exist_ok=True)
        (run / rel).write_text("x")
    res, launches, _ = fake([{"rows": [1], "rc": 0}])
    found = set(launches[0]["found"])
    assert set(keep) <= found
    assert not {"train/ckpt_000000003.pt.tmp", "infer/3.tmp", "infer_best/3.tmp"} & found
    assert sorted(e.split(" ", 2)[2] for e in res.events if " removed " in e) == [
        "removed infer/3.tmp", "removed infer_best/3.tmp", "removed train/ckpt_000000003.pt.tmp"]


@pytest.mark.parametrize("args,want", [(["--steps", "5"], 5), (["--steps=7", "--x"], 7),
                                       (["--config", "base"], None), (["--steps-x", "3"], None)])
def test_total_steps(args, want):
    assert W.total_steps(args) == want


def test_the_entry_point_killed_after_its_first_full_save(tmp_path, monkeypatch):
    """python -m nsc_tpu_torch.train on tiny_test (CPU, 3 steps, a full
    state at 1 and 3) under the watchdog: SIGKILLed once the step-1
    boundary's writes are done, relaunched once, resumed from step 1,
    complete at step 3. The boundary writes the full state, then the
    inference export, then (a first boundary improves on no best) the best
    export and best.json, last; a kill between the full state and the
    export loses export 1 for good, in the JAX package's loop as in this
    one (the relaunch resumes after step 1), so the kill waits for
    best.json."""
    run, pid_file = tmp_path / "run", tmp_path / "train.pid"
    ckpt1 = run / "train" / os.path.basename(ckpt.path_for("", 1))
    best = run / "best.json"
    killed = {}

    def step1_boundary_written():
        try:
            return ckpt1.exists() and json.loads(best.read_text())["step"] >= 1
        except (OSError, ValueError, KeyError):
            return False

    def kill_after_first_full_save():
        deadline = time.time() + 300
        while not step1_boundary_written() and time.time() < deadline:
            time.sleep(0.02)
        pid = int(pid_file.read_text())
        os.kill(pid, signal.SIGKILL)
        killed["pid"] = pid

    t = threading.Thread(target=kill_after_first_full_save, daemon=True)
    t.start()
    args = ["--config", "tiny_test", "--device", "cpu", "--steps", "3", "--batch-size", "2",
            "--segment-seconds", "0.128", "--no-gan", "--checkpoint-every", "1",
            "--full-state-every", "2"]
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = W.supervise(str(run), args, poll=0.2, grace_s=600.0, stale_s=600.0,
                      pid_file=str(pid_file), stop_file=str(tmp_path / "stop"))
    t.join(10)
    if res.proc.poll() is None:  # complete by the row at step 3: the final save follows
        assert res.proc.wait(120) == 0
    log = (tmp_path / "run.log").read_text()
    assert (res.status, res.restarts) == ("complete", 1), (res.events, log[-3000:])
    assert "resumed from step 1" in log
    assert W.logged_step(str(run / "metrics.jsonl"), 3)
    assert ckpt.all_steps(str(run / "train"))[-1] == 3
    assert ckpt.export_steps(str(run / "infer")) == [1, 2, 3]
    left = [os.path.join(d, n) for d, ds, fs in os.walk(run) for n in ds + fs
            if n.endswith(".tmp")]
    assert left == []


# ---------------------------------------------------------------------------
# the harvester
# ---------------------------------------------------------------------------


def _export(directory, step, value=0.0):
    return ckpt.save_inference(str(directory), step, {"w": np.full(4, value, np.float32)},
                               {"codebooks": np.full((1, 2, 2), value, np.float32)},
                               {"config": "tiny_test"}, max_to_keep=None)


def test_harvest_copies_every_step_and_skips_tmp_names(tmp_path):
    for s in (1, 2):
        _export(tmp_path / "infer", s, s)
    (tmp_path / "infer" / "3.tmp").mkdir()
    lines = []
    assert harvest.harvest_once(str(tmp_path), lines.append) == [1, 2]
    assert sorted(os.listdir(tmp_path / "harvest")) == ["1", "2"]
    for s in (1, 2):
        for name in (ckpt.EXPORT_WEIGHTS, ckpt.EXPORT_META):
            a = (tmp_path / "infer" / str(s) / name).read_bytes()
            assert (tmp_path / "harvest" / str(s) / name).read_bytes() == a
    assert [ln.split(" ", 1)[1] for ln in lines] == ["harvested 1", "harvested 2"]
    assert harvest.harvest_once(str(tmp_path), lines.append) == []  # each step once


def test_harvest_refuses_weights_that_miss_their_sha(tmp_path, capsys):
    step_dir = _export(tmp_path / "infer", 2, 2.0)
    with open(os.path.join(step_dir, ckpt.EXPORT_WEIGHTS), "r+b") as f:
        f.seek(-9, os.SEEK_END)
        f.write(b"\x01")
    assert harvest.harvest_once(str(tmp_path), print) == []
    assert os.listdir(tmp_path / "harvest") == []
    assert "sha256" in capsys.readouterr().err


def test_harvest_a_source_that_vanishes_mid_copy_is_a_miss(tmp_path, monkeypatch, capsys):
    _export(tmp_path / "infer", 1, 1.0)
    _export(tmp_path / "infer", 2, 2.0)
    real = shutil.copytree

    def evicting(src, dst, **kw):
        def copy(a, b, **k):  # the first file copied, then the export evicted
            shutil.copy2(a, b)
            if src.endswith(os.sep + "1"):
                shutil.rmtree(src, ignore_errors=True)
        return real(src, dst, copy_function=copy, **kw)

    monkeypatch.setattr(harvest.shutil, "copytree", evicting)
    assert harvest.harvest_once(str(tmp_path), print) == [2]
    assert sorted(os.listdir(tmp_path / "harvest")) == ["2"]
    err = capsys.readouterr().err
    assert "missed 1" in err and "vanished" in err


def test_harvest_exits_after_a_final_sweep_once_the_pid_is_gone(tmp_path):
    pid_file = tmp_path / "watch.pid"
    pid_file.write_text(f"{os.getpid()}\n")
    _export(tmp_path / "infer", 1, 1.0)
    lines, got = [], []
    t = threading.Thread(target=lambda: got.extend(harvest.harvest(
        str(tmp_path), str(pid_file), poll=0.05, log=lines.append)), daemon=True)
    t.start()
    time.sleep(0.3)
    assert t.is_alive()
    _export(tmp_path / "infer", 2, 2.0)
    gone = subprocess.Popen([sys.executable, "-c", "pass"])
    gone.wait(30)
    pid_file.write_text(f"{gone.pid}\n")
    t.join(10)
    assert not t.is_alive()
    assert got == [1, 2]
    assert lines[-1].endswith("training pid gone; harvest complete")
    assert not harvest.pid_alive(str(tmp_path / "missing.pid"))
