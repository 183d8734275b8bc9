"""The Merkleization race of the port (the counterpart of
consensus_specs_tpu/bench/merkle.py), ``run_merkle_bench(device=None)``.
The plane is the host's: ``device`` is resolved by the port's rule and
runs nothing.

Three cells, each the native batched plane vs the pure-python oracle on
IDENTICAL inputs with bit-identity checked per cell (each cell's ``ok``
is its gate; the throughput numbers are report-only):

- ``merkle[state_cold]``       — full altair BeaconState
  (CONSENSUS_SPECS_TPU_MERKLE_VALIDATORS registry) hash_tree_root from a
  fresh ``decode_bytes`` (cold caches) — the column-batched plane's
  headline: one native call per tree level instead of ~9 hashlib calls
  per validator.
- ``merkle[state_incremental]`` — per-block re-root: a block's state
  delta (touched validators + one deposit append) against the warm
  incremental layer cache vs a from-scratch pure-python rebuild —
  blocks/sec, the O(log N · changed) dirty-set bar.
- ``merkle[proof_world]``       — the proof plane's consumer number:
  per-slot ``build_update_artifact`` (+sign) on cold states through the
  native plane vs forced-python, same states.

Modes are forced through ``merkle/levels.forced_mode`` so one process
measures both sides; ``merkle.*`` counter gauges and the
``latency[merkle_root]`` histogram ride along in the result, and each
cell carries the root both sides agreed on (``root``).
"""
import os
import time

VALIDATORS_ENV = "CONSENSUS_SPECS_TPU_MERKLE_VALIDATORS"
BLOCKS_ENV = "CONSENSUS_SPECS_TPU_MERKLE_BLOCKS"
TOUCH_ENV = "CONSENSUS_SPECS_TPU_MERKLE_TOUCH"


def run_merkle_bench(device=None) -> dict:
    from ..builder import build_spec_module
    from ..device import resolve_device
    from ..lightclient.proof_tree import ProofWorld, build_update_artifact
    from ..merkle import levels as _levels
    from ..obs import latency
    from ..ops import profiling
    from ..utils.ssz.ssz_impl import hash_tree_root

    device = resolve_device(device)
    profiling.reset()
    latency.reset()
    _levels.reset_counters()

    from ..scale.registry import attesters_per_slot

    n_validators = int(os.environ.get(VALIDATORS_ENV, "16384"))
    n_blocks = max(1, int(os.environ.get(BLOCKS_ENV, "16")))
    # the per-block state delta defaults to the registry's REAL per-slot
    # attestation fan-out (n/SLOTS_PER_EPOCH — every committee of the
    # slot, the same shape the mainnet replay drives), not a made-up
    # constant; TOUCH_ENV still overrides for sweeps
    n_touch = max(1, int(os.environ.get(
        TOUCH_ENV, str(attesters_per_slot(n_validators)))))

    spec = build_spec_module("altair", "minimal")
    world = ProofWorld(spec, validators=n_validators)
    state = world.head_state(world.finalized_slot + 1)
    enc_state = state.encode_bytes()
    enc_fin = world.finalized_state.encode_bytes()

    cells = {}
    all_ok = True

    # -- merkle[state_cold]: full-state cold root ------------------------
    def cold_root(mode: str):
        with _levels.forced_mode(mode):
            fresh = spec.BeaconState.decode_bytes(enc_state)
            t0 = time.perf_counter()
            root = bytes(hash_tree_root(fresh))
            return root, time.perf_counter() - t0

    py_root, _ = cold_root("python")
    na_root, _ = cold_root("native")
    py_s = min(cold_root("python")[1] for _ in range(3))
    na_s = min(cold_root("native")[1] for _ in range(3))
    ok = py_root == na_root
    all_ok &= ok
    cells["state_cold"] = {
        "ok": bool(ok),
        "python_s": round(py_s, 5),
        "native_s": round(na_s, 5),
        "speedup": round(py_s / na_s, 2) if na_s > 0 else 0.0,
        "roots_per_sec": round(1.0 / na_s, 2) if na_s > 0 else 0.0,
        "validators": n_validators,
        "root": na_root.hex(),
    }

    # -- merkle[state_incremental]: per-block re-root --------------------
    # one warm native state absorbs every block's delta through the
    # incremental cache; the python side re-roots a from-scratch decode
    # carrying the same cumulative delta (the pre-plane per-block cost)
    def apply_delta(st, b: int) -> None:
        for k in range(n_touch):
            i = (b * n_touch + k) % len(st.validators)
            st.validators[i].effective_balance = spec.Gwei(
                31 * 10**9 + b * n_touch + k)
        st.validators.append(spec.Validator(
            pubkey=spec.BLSPubkey((10**6 + b).to_bytes(48, "little")),
            effective_balance=spec.Gwei(32 * 10**9)))
        st.slot = spec.Slot(int(st.slot) + 1)

    warm = spec.BeaconState.decode_bytes(enc_state)
    with _levels.forced_mode("native"):
        hash_tree_root(warm)  # seed the caches
    nat_s = 0.0
    py_blocks_s = []
    inc_ok = True
    py_ref = spec.BeaconState.decode_bytes(enc_state)
    for b in range(n_blocks):
        apply_delta(warm, b)
        with _levels.forced_mode("native"):
            t0 = time.perf_counter()
            r_inc = bytes(hash_tree_root(warm))
            nat_s += time.perf_counter() - t0
        # oracle: same cumulative delta, cold from-scratch python re-root
        apply_delta(py_ref, b)
        with _levels.forced_mode("python"):
            fresh = spec.BeaconState.decode_bytes(py_ref.encode_bytes())
            t0 = time.perf_counter()
            r_py = bytes(hash_tree_root(fresh))
            py_blocks_s.append(time.perf_counter() - t0)
        inc_ok &= r_inc == r_py
    py_s_total = sum(py_blocks_s)
    all_ok &= inc_ok
    cells["state_incremental"] = {
        "ok": bool(inc_ok),
        "python_s_per_block": round(py_s_total / n_blocks, 5),
        "native_s_per_block": round(nat_s / n_blocks, 6),
        "speedup": round(py_s_total / nat_s, 2) if nat_s > 0 else 0.0,
        "blocks_per_sec": round(n_blocks / nat_s, 2) if nat_s > 0 else 0.0,
        "blocks": n_blocks,
        "touched_per_block": n_touch,
        "root": r_inc.hex(),
    }

    # -- merkle[proof_world]: artifact build+sign on cold states ---------
    def timed_build(mode: str, slot: int):
        st = world.head_state(slot)
        fin = spec.BeaconState.decode_bytes(enc_fin)
        with _levels.forced_mode(mode):
            t0 = time.perf_counter()
            art = build_update_artifact(
                spec, st, fin,
                genesis_validators_root=world.genesis_validators_root,
                sign=world.sign)
            return art, time.perf_counter() - t0

    base = world.finalized_slot + 100
    a_na, _ = timed_build("native", base)
    a_py, _ = timed_build("python", base)
    na_bs = min(timed_build("native", base + 1 + k)[1] for k in range(3))
    py_bs = min(timed_build("python", base + 1 + k)[1] for k in range(3))
    pw_ok = (bytes(a_na.state_root) == bytes(a_py.state_root)
             and a_na.finality_branch == a_py.finality_branch
             and a_na.multi_proof == a_py.multi_proof)
    all_ok &= pw_ok
    cells["proof_world"] = {
        "ok": bool(pw_ok),
        "python_s_per_slot": round(py_bs, 5),
        "native_s_per_slot": round(na_bs, 5),
        "speedup": round(py_bs / na_bs, 2) if na_bs > 0 else 0.0,
        "validators": n_validators,
        "root": bytes(a_na.state_root).hex(),
    }

    _levels.export_gauges()
    lat = latency.snapshot()
    counters = dict(_levels.counters)

    inc = cells["state_incremental"]
    return dict(
        metric="incremental state re-roots/sec (native plane)",
        value=inc["blocks_per_sec"],
        vs_baseline=cells["state_cold"]["speedup"],
        unit="blocks/sec",
        mode="merkle",
        platform=device.type,
        merkle_mode=_levels.mode(),
        native_available=bool(_levels.plane_enabled()),
        validators=n_validators,
        ok=bool(all_ok),
        cold_speedup=cells["state_cold"]["speedup"],
        incremental_speedup=inc["speedup"],
        proof_world_speedup=cells["proof_world"]["speedup"],
        roots_per_sec=cells["state_cold"]["roots_per_sec"],
        blocks_per_sec=inc["blocks_per_sec"],
        merkle=cells,
        counters=counters,
        per_mode_best={
            f"merkle[{name}]": cell["speedup"] for name, cell in cells.items()
        },
        stage_latency=lat,
        profile=profiling.summary(),
    )
