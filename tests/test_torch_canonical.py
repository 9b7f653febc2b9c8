"""The port's canonical-index pins (`nsc_tpu_torch/canonical.py`).

The probes equal nsc_tpu's bit for bit (the speech probe through the
port's own SyntheticSourceV2). A pin written on the CPU for `tiny_test`
(the float32 bundle, as nsc_tpu's own pin tests use: the pin code does
not depend on the compute dtype, and bf16 convs are slow on the CPU)
checks back exact there; a pin from other codebooks, of another version,
or absent, gives exact=None; a pin from another backend is labelled so.
Tolerances: none (indices are compared for equality).
"""

import os

import numpy as np
import pytest

from nsc_tpu import canonical as JCAN
from nsc_tpu.configs import get_config
from nsc_tpu_torch import api as PA
from nsc_tpu_torch import canonical as PCAN
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPORT = os.path.join(ROOT, "exports", "base_fast_synthetic2_48k_refit")


@pytest.mark.parametrize("probe", ["probe_input", "speech_probe_input"])
def test_probes_equal_nsc_tpu(probe):
    cfg = get_config("base_fast")
    want = getattr(JCAN, probe)(cfg)
    got = getattr(PCAN, probe)(PA.get_config("base_fast"))
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (8, 160000)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(getattr(PCAN, probe)(PA.get_config("base_fast"), 3), want[:3])


@pytest.fixture(scope="module")
def bundle():
    return PA.load_model("tiny_test", device="cpu")


@pytest.fixture(scope="module")
def pin(bundle, tmp_path_factory):
    """A pin of the tiny_test bundle, written once."""
    return PCAN.write_pin(bundle, str(tmp_path_factory.mktemp("pin")))


def _copy(pin, tmp_path):
    import shutil

    shutil.copy(pin, tmp_path / PCAN.PIN_NAME)
    return str(tmp_path)


def test_write_and_check_pin_round_trip(bundle, pin, tmp_path):
    path = PCAN.pin_path(_copy(pin, tmp_path))
    assert pin.endswith("canonical_idx_gpu.npz")
    assert PCAN.backend(bundle.device) == "cpu"
    exact, rate, status, same_backend = PCAN.check_pin(bundle, str(tmp_path))
    assert (exact, rate, same_backend) == (True, 1.0, True)
    assert status == "vs pinned canonical indices (noise + speech probes)"
    with np.load(path) as z:
        assert z["indices"].shape == z["indices_speech"].shape == (8, 40000, 2)
        assert int(z["fingerprint"]) == PA.codebook_fingerprint(bundle.rvq)
        assert str(z["config"]) == "tiny_test"


def _rewrite(path, **changes):
    with np.load(path) as z:
        fields = {k: z[k] for k in z.files}
    fields.update(changes)
    np.savez_compressed(path, **fields)


def test_pin_that_does_not_apply_gives_none(bundle, pin, tmp_path):
    d = str(tmp_path)
    assert PCAN.check_pin(bundle, d) == (None, 0.0, "no canonical pin at checkpoint", False)
    _copy(pin, tmp_path)
    other = PA.load_model("tiny_test", seed=1, device="cpu")
    assert PCAN.check_pin(other, d) == (None, 0.0, "pin was made from different codebooks", True)
    _rewrite(PCAN.pin_path(d), version=np.int32(PCAN.PIN_VERSION + 1))
    assert PCAN.check_pin(bundle, d) == (None, 0.0, f"pin version {PCAN.PIN_VERSION + 1} unsupported",
                                          True)


def test_pin_mismatch_and_other_backend_are_reported(bundle, pin, tmp_path):
    d = _copy(pin, tmp_path)
    with np.load(PCAN.pin_path(d)) as z:
        idx = z["indices"].copy()
    idx[0, 0, 0] = (idx[0, 0, 0] + 1) % bundle.cfg.codebook_size
    _rewrite(PCAN.pin_path(d), indices=idx, backend=np.array("another card"))
    exact, rate, status, same_backend = PCAN.check_pin(bundle, d)
    assert exact is False and rate == 1 - 1 / (2 * idx.size) and not same_backend
    assert status.endswith("(pin from 'another card', checking on 'cpu')")


def test_committed_gpu_pin_belongs_to_the_export():
    """The committed pin was written on a card from the committed export's
    serving bundle: its fingerprint and shapes are the export's."""
    from nsc_tpu_torch.train import checkpoint as ckpt

    meta = ckpt.export_meta(EXPORT)
    with np.load(PCAN.pin_path(EXPORT), allow_pickle=False) as z:
        assert int(z["version"]) == PCAN.PIN_VERSION
        assert int(z["fingerprint"]) == meta["fingerprint"]
        assert str(z["config"]) == "base_fast"
        assert z["indices"].shape == z["indices_speech"].shape == (8, 500, 16)
        assert str(z["backend"]).startswith("NVIDIA H100")
