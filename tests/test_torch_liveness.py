"""The port's device-liveness probe and stall detector
(`nsc_tpu_torch/utils/liveness.py`): the seven cases of
`tests/unit/test_liveness.py`, on the CPU (the probe on device "cpu"), and
a malformed NSC_RSS_EXIT_GB, which the port reads as unset.

The wedge paths inject a recording `_exit` instead of calling the real
`os._exit`; the real exit code is checked in a child interpreter."""

import functools
import subprocess
import sys
import time

from nsc_tpu_torch.utils import liveness
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU_PROBE = functools.partial(liveness._default_probe, "cpu")


def test_device_check_passes_on_healthy_backend():
    dt = liveness.device_liveness_check(timeout_s=60.0, probe=CPU_PROBE)
    assert dt < 60.0
    assert CPU_PROBE() == 8 * 128 * 4.0


def test_run_with_deadline_ok_error_timeout():
    status, value, dt = liveness.run_with_deadline(lambda: 41 + 1, 5.0)
    assert (status, value) == ("ok", 42) and dt < 5.0

    def boom():
        raise RuntimeError("no backend")

    status, value, _ = liveness.run_with_deadline(boom, 5.0)
    assert status == "error" and isinstance(value, RuntimeError)
    status, value, dt = liveness.run_with_deadline(lambda: time.sleep(1.0), 0.1)
    assert (status, value) == ("timeout", None) and dt == 0.1


def test_heartbeat_env_override(monkeypatch):
    monkeypatch.setenv("NSC_HEARTBEAT_TIMEOUT", "123")
    monkeypatch.setenv("NSC_HEARTBEAT_FIRST", "456")
    hb = liveness.Heartbeat(poll_s=60.0, _exit=lambda c: None)
    try:
        assert hb._timeout == 123.0
    finally:
        hb.stop()


def test_device_check_exits_on_wedged_probe():
    codes = []
    liveness.device_liveness_check(timeout_s=0.2, probe=lambda: time.sleep(1.0),
                                   _exit=codes.append)
    assert codes == [liveness.EXIT_DEVICE_WEDGED]


def test_heartbeat_fires_after_silence_and_reports_last_step():
    codes = []
    hb = liveness.Heartbeat(timeout_s=0.3, first_timeout_s=0.3, poll_s=0.05, _exit=codes.append)
    hb.beat(41)
    deadline = time.monotonic() + 5.0
    while not codes and time.monotonic() < deadline:
        time.sleep(0.05)
    hb.stop()
    assert codes and codes[0] == liveness.EXIT_STALLED


def test_heartbeat_quiet_while_beating():
    codes = []
    hb = liveness.Heartbeat(timeout_s=0.4, first_timeout_s=0.4, poll_s=0.05, _exit=codes.append)
    for _ in range(8):
        hb.beat()
        time.sleep(0.1)
    hb.stop()
    time.sleep(0.2)
    assert codes == []


def test_real_exit_code_via_subprocess():
    code = (
        "from nsc_tpu_torch.utils import liveness\n"
        "import time\n"
        "liveness.device_liveness_check(timeout_s=0.2, probe=lambda: time.sleep(30))\n"
    )
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60)
    assert p.returncode == liveness.EXIT_DEVICE_WEDGED
    assert "NSC-LIVENESS: DEVICE WEDGED" in p.stderr  # stdout stays the program's


def test_malformed_rss_limit_counts_as_unset(monkeypatch):
    monkeypatch.delenv("NSC_RSS_EXIT_GB", raising=False)
    default = liveness.rss_exit_limit_gb()
    monkeypatch.setenv("NSC_RSS_EXIT_GB", "12GB")
    assert liveness.rss_exit_limit_gb() == default
    monkeypatch.setenv("NSC_RSS_EXIT_GB", "0")
    assert liveness.rss_exit_limit_gb() is None
    monkeypatch.setenv("NSC_RSS_EXIT_GB", "1.5")
    assert liveness.rss_exit_limit_gb() == 1.5
    assert liveness.host_rss_gb() > 0.0
