"""Every public name of palace_tpu has its counterpart in the port.

For each module of palace_tpu, read with an AST (the package is never
imported here), every public name it defines at module level, and every
name its ``__init__`` exports, must be an attribute of the port's module of
the same path, or stand in ``NOT_PORTED`` with the reason it is not
ported (ROADMAP.md, "Not ported, by design", is the same list)."""
import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "palace_tpu"
PORT_PKG = ROOT / "palace_tpu_torch"

_TRACED_TABLE = ("XLA:TPU's int32 index limits need a 2-D or nibble-packed table; the "
                 "port's table is one flat uint8 tensor with int64 indices")
#: "module path" (the whole module) or "module path:name" → why it is not ported
NOT_PORTED = {
    "_native/__init__.py": "locates the JAX package's prebuilt native artefacts; the port "
                           "builds its native sources with g++ at first use "
                           "(palace_tpu_torch/native/_build.py)",
    "ops/pallas_kernels.py": "the Pallas TPU kernels; their counterpart is "
                             "palace_tpu_torch/ops/kernels.py, a CUDA kernel beside a plain "
                             "version for each",
    "utils/compile_cache.py": "XLA's persistent compilation cache; the port's kernels are "
                              "built by nvcc into build/, named by a hash of their sources",
    "ops/kmer.py:pack_codes_wire": "the TPU wire format, for reads sent to a TPU over a "
                                   "network relay; the port copies codes to a local card",
    "ops/kmer.py:unpack_codes_wire": "the TPU wire format (see pack_codes_wire)",
    "ops/kmer.py:WIRE_EXC_CAP": "the TPU wire format (see pack_codes_wire)",
    "ops/kmer.py:kmer_hashes_traced": "a traced XLA helper for jit; the port hashes with "
                                      "kmer_hashes on tensors",
    "ops/count_table.py:split_hash": _TRACED_TABLE,
    "ops/count_table.py:lookup_traced": _TRACED_TABLE,
    "ops/count_table.py:table_shape": _TRACED_TABLE,
    "ops/count_table.py:packed_table_shape": _TRACED_TABLE,
    "ops/count_table.py:ROW_BITS": _TRACED_TABLE,
    "ops/count_table.py:NIBBLE_CLAMP_EVERY": _TRACED_TABLE,
    "search/eref.py:ShardedOverflowError": "the port's sharded count table gathers every "
                                           "rank's pairs whole and drops nothing, so it "
                                           "never overflows",
    "io/fastq_native.py:packer_lib": "the native 2-bit contig packer; the port's scorer "
                                     "sends ASCII bytes to K1 and builds no packer",
}

MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def public_names(path: Path) -> set:
    """Module-level defs, classes and assignments not starting with ``_``,
    and, in an ``__init__``, the names imported from the package."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif (isinstance(node, ast.ImportFrom) and path.name == "__init__.py"
              and (node.module or "").startswith("palace_tpu")):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def port_module(rel: str) -> str:
    parts = Path(rel).with_suffix("").parts
    return ".".join(("palace_tpu_torch",) + (parts[:-1] if parts[-1] == "__init__" else parts))


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_name_is_ported_or_named(rel):
    names = public_names(JAX_PKG / rel)
    if rel in NOT_PORTED:
        assert not (PORT_PKG / rel).exists(), f"{rel} is ported: take it out of NOT_PORTED"
        return
    assert (PORT_PKG / rel).exists(), f"palace_tpu_torch/{rel} is missing"
    if not names:  # nothing to look up (``__main__`` runs the CLI when imported)
        return
    mod = importlib.import_module(port_module(rel))
    missing = sorted(n for n in names if not hasattr(mod, n) and f"{rel}:{n}" not in NOT_PORTED)
    assert not missing, f"{port_module(rel)} lacks {missing}"


def test_not_ported_names_exist_in_jax_and_not_in_the_port():
    """No entry of NOT_PORTED is stale: each names a module or name of
    palace_tpu that the port does not have."""
    for key, reason in NOT_PORTED.items():
        rel, _, name = key.partition(":")
        assert reason and (JAX_PKG / rel).exists(), key
        if name:
            assert name in public_names(JAX_PKG / rel), key
            assert not hasattr(importlib.import_module(port_module(rel)), name), key
