#!/usr/bin/env python3
"""Prune the port's program cache, the counterpart of `make vm-cache-prune`.

    python tools/torch_vm_cache_prune.py

Runs ``consensus_specs_tpu_torch.ops.bls_backend.prune_vm_cache`` on
``.vm_cache_torch/`` (or CONSENSUS_SPECS_TPU_VM_CACHE): entries that can
never hit again in this tree go first (another cache version, a moved
per-program fingerprint, another lowering version), then entries idle
longer than VM_CACHE_MAX_AGE_DAYS (default 30), then the oldest until the
rest fits VM_CACHE_MAX_BYTES (default 2 GiB); shared fused structure
bodies go once no plan references them. Prints the result as one JSON
line: kept, evicted, kept_bytes, evicted_bytes.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from consensus_specs_tpu_torch.ops.bls_backend import prune_vm_cache  # noqa: E402

if __name__ == "__main__":
    print(json.dumps(prune_vm_cache()))
