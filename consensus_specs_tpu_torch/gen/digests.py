"""Digests of whole vector trees, and the pinned digests of the trees the
JAX package's generators write.

``tree_digest(root)`` is a sha256 over every file under ``root``, in the
order of their relative POSIX paths: each path, a NUL, the file's length
in 8 little-endian bytes, then its bytes. ``tests/test_torch_gen_*.py``
hold each port tree byte for byte against the JAX generator's and the JAX
tree's digest against ``PINNED``; ``chip_smoke.py`` phase ``gen`` holds
the trees the port writes on the card's machine against the same
constants.
"""
import hashlib
from pathlib import Path

# generator -> digest of its tree (the CLI selection in the key)
PINNED = {
    "bls":
        "c0df115e452bb6f190e4b30ef3e302c3dc407bfe2b29c5687b5100bf3cf957eb",
    "ssz_generic":
        "06451ef25b0596998bd1b239f587feb937bb7ae2728e617fab3f1ebbd43cde32",
    "shuffling -l minimal":
        "90a14ade57a1d7973a489b3a99fc076a5ca22f0d11cd6da1b2f98fb535990371",
    "merkle -l minimal":
        "f7fe9718f919010d6725fa730cbeb9a755b4f02022993944c746cd009621746f",
    "ssz_static -l minimal (phase0, altair)":
        "f3d8c1343b7d6dc373570ac3722bfa3be376d3c74d23b5d3e39ef6a64b1d1dfa",
}


def tree_digest(root) -> str:
    root = Path(root)
    h = hashlib.sha256()
    files = sorted((p.relative_to(root).as_posix(), p)
                   for p in root.rglob("*") if p.is_file())
    for rel, path in files:
        data = path.read_bytes()
        h.update(rel.encode() + b"\0" + len(data).to_bytes(8, "little") + data)
    return h.hexdigest()
