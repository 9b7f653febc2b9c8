"""Write the port's canonical-index pin of an exported checkpoint on the card.

    python3 scripts/torch_write_gpu_pin.py [EXPORT_DIR] [--model base_fast] [--device cpu]

Loads the export's serving bundle (`nsc_tpu_torch.load_model(...,
serving=True)`, on CUDA), encodes the two canonical probes and writes
`canonical_idx_gpu.npz` beside the export (`nsc_tpu_torch.canonical`). The
pin records the card's name and the torch, CUDA and cuDNN versions it was
made with; `check_pin` on the same card and software must reproduce it bit
for bit. Prints one JSON line: the pin's path, backend and fingerprint.
`--device cpu` pins the CPU path instead (for a rehearsal; the pin then
records the CPU backend). Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
EXPORT = os.path.join(REPO, "exports", "base_fast_synthetic2_48k_refit")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("export", nargs="?", default=EXPORT)
    p.add_argument("--model", default="base_fast")
    p.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)

    from nsc_tpu_torch import api, canonical

    bundle = api.load_model(args.model, checkpoint=args.export, serving=True, device=args.device)
    path = canonical.write_pin(bundle, args.export)
    exact, rate, status, _ = canonical.check_pin(bundle, args.export)
    print(json.dumps({"pin": os.path.relpath(path, REPO), "backend": canonical.backend(bundle.device),
                      "fingerprint": api.codebook_fingerprint(bundle.rvq),
                      "recheck_exact": exact, "recheck_rate": rate, "status": status}))
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
