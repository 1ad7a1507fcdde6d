"""Every module of the reference has its twin in the port, and every public
top-level name of a reference module exists in its twin.

An AST walk over both source trees; it imports neither package.  A
reference name the port leaves out on purpose stands in ``DELIBERATE``
with its reason; any other missing name fails, and so does an entry of
``DELIBERATE`` whose name the port has since gained.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

_BACKEND_SWITCH = ("the port picks kernel or plain version by the tensor's "
                   "device, not by an accel backend or EVA_CIM_ACCEL "
                   "(repro_torch/core/accel/__init__.py)")
_LAYOUTS = ("the port states parameters as layers.Leaf layouts and fills "
            "them from a torch.Generator or numpy, not from jax.random "
            "initializers")

#: (reference module, name) -> why the port has no such name
DELIBERATE = {
    **{("core/accel/__init__.py", name): _BACKEND_SWITCH for name in (
        "BACKENDS", "ENV_VAR", "backend", "enabled", "set_backend",
        "use_backend", "register_jitted", "jit_compiles", "replay_columns",
        "place_candidates")},
    ("core/accel/place.py", "place_candidates_jax"):
        "the jitted placement is K4, the CUDA kernel behind place_arrays",
    ("core/roofline.py", "ART"):
        "the reference's dry-run artifact directory; the port's records "
        "live in its own directory (launch/dryrun.py)",
    ("kernels/cim_bitwise.py", "BLOCK_C"):
        "a Pallas tile width; the CUDA kernel sizes its own blocks",
    ("kernels/cim_bitwise.py", "BLOCK_R"):
        "a Pallas tile height; the CUDA kernel sizes its own blocks",
    ("kernels/flash_attention.py", "NEG_INF"):
        "the Pallas kernel's -1e30; the CUDA kernel holds the same "
        "constant (kernels/csrc/flash_attention.cu)",
    ("kernels/mlstm_chunk.py", "NEG_INF"):
        "the Pallas kernel's -1e30; the CUDA kernel holds the same "
        "constant (kernels/csrc/mlstm_chunk.cu)",
    **{(mod, name): _LAYOUTS for mod, name in (
        ("models/attention.py", "make_attn_params"),
        ("models/layers.py", "dense_init"),
        ("models/layers.py", "embed_init"),
        ("models/layers.py", "make_norm_params"),
        ("models/layers.py", "make_swiglu_params"),
        ("models/layers.py", "pdtype_of"),
        ("models/layers.py", "stack_layer_params"),
        ("models/moe.py", "make_moe_params"),
        ("models/ssm.py", "make_mamba_params"),
        ("models/ssm.py", "make_mlstm_params"),
        ("models/ssm.py", "make_slstm_params"))},
}


def _modules():
    return sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


def _defined(path: pathlib.Path, imports: bool):
    """Top-level names a module binds: defs, classes, assignment targets
    and, with ``imports``, imported names."""
    out = set()
    for stmt in ast.parse(path.read_text()).body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(stmt.name)
        elif isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for target in targets:
                out.update(n.id for n in ast.walk(target)
                           if isinstance(n, ast.Name))
        elif imports and isinstance(stmt, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0]
                       for a in stmt.names)
    return out


def _public(path: pathlib.Path):
    return sorted(n for n in _defined(path, imports=False)
                  if not n.startswith("_"))


@pytest.mark.parametrize("mod", _modules())
def test_reference_module_has_its_twin(mod):
    twin = PORT / mod
    assert twin.exists(), f"src/repro/{mod} has no twin src/repro_torch/{mod}"
    have = _defined(twin, imports=True)
    missing = [n for n in _public(REF / mod)
               if n not in have and (mod, n) not in DELIBERATE]
    assert not missing, f"src/repro_torch/{mod} lacks {missing}"


@pytest.mark.parametrize("key", sorted(DELIBERATE))
def test_deliberate_difference_still_holds(key):
    """Each entry names a public reference name the port really lacks."""
    mod, name = key
    assert name in _public(REF / mod), f"src/repro/{mod} has no {name}"
    assert name not in _defined(PORT / mod, imports=True), \
        f"src/repro_torch/{mod} has {name}: drop it from DELIBERATE"
    assert DELIBERATE[key].strip()
