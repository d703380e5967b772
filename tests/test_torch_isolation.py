"""PyTorch port: it stands alone. No file of ace_tpu_torch/, nor
chip_smoke.py, run_resnet_torch.py or scripts/torch_*.py, imports jax or
ace_tpu; importing the port leaves jax unloaded; it reads no environment
variable but the runtime timer's, and the zoo and accuracy scripts none; its native host code is a source that builds outside
the package; its entry points refuse to fall back to the CPU
silently."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    files = [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                              "run_resnet_torch.py")]
    scripts = os.path.join(REPO, "scripts")
    files += [os.path.join(scripts, n) for n in sorted(os.listdir(scripts))
              if n.startswith("torch_") and n.endswith(".py")]
    for root, _, names in os.walk(os.path.join(REPO, "ace_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_no_jax_or_ace_tpu_imports():
    files = _port_files()
    assert len(files) > 20
    for new in ("scripts/torch_report.py", "ace_tpu_torch/parallel/mesh.py"):
        assert os.path.join(REPO, new) in files
    bad = [(os.path.relpath(f, REPO), m) for f in files
           for m in _imported_roots(f) if m in ("jax", "jaxlib", "ace_tpu")]
    assert not bad, bad


def test_import_leaves_jax_unloaded():
    code = ("import sys; import ace_tpu_torch.models.resnet, "
            "ace_tpu_torch.interop, ace_tpu_torch.ops.ntt4, "
            "ace_tpu_torch.ops.kernels, ace_tpu_torch.driver, "
            "ace_tpu_torch.utils.options, ace_tpu_torch.runtime.validate, "
            "ace_tpu_torch.runtime.ckpt, ace_tpu_torch.runtime.rt_data, "
            "ace_tpu_torch.runtime.block_io, ace_tpu_torch.ckks.nonlinear, "
            "ace_tpu_torch.models.llama, ace_tpu_torch.models.llama_fhe, "
            "ace_tpu_torch.parallel.mesh, ace_tpu_torch.parallel.spmd_eval, "
            "tests.torch_limb_worker, tests.torch_spmd_worker; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'ace_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reads_only_the_timing_variable():
    """os.environ / os.getenv appear only for RTLIB_TIMING_OUTPUT."""
    for f in _port_files():
        for node in ast.walk(ast.parse(open(f).read(), f)):
            if isinstance(node, ast.Attribute) and node.attr in (
                    "environ", "getenv", "environb", "getenvb"):
                line = open(f).read().splitlines()[node.lineno - 1]
                assert "RTLIB_TIMING_OUTPUT" in line, (f, line)


def test_zoo_scripts_read_no_environment_variable():
    """The zoo and accuracy scripts enable the timer through
    TIMING.enabled, not RTLIB_TIMING_OUTPUT as scripts/zoo.py does."""
    names = [os.path.join(REPO, "scripts", n) for n in ("torch_zoo.py",
                                                         "torch_accuracy.py")]
    assert set(names) <= set(_port_files())
    for f in names:
        src = open(f).read()
        assert "RTLIB_TIMING_OUTPUT" not in src, f
        for node in ast.walk(ast.parse(src, f)):
            assert not (isinstance(node, ast.Attribute) and node.attr in (
                "environ", "getenv", "environb", "getenvb")), (f, node.lineno)


def test_native_sources_build_outside_the_package():
    """ace_tpu_torch/native holds C++ sources only (ace_tpu commits its
    libblock_io.so; the port does not), and the block-IO library builds
    into the git-ignored build directory of the CUDA kernels."""
    from ace_tpu_torch.ops import kernels
    from ace_tpu_torch.runtime import block_io
    pkg = os.path.join(REPO, "ace_tpu_torch")
    built = [os.path.join(r, n) for r, _, names in os.walk(pkg)
             for n in names if n.endswith((".so", ".o"))]
    assert not built, built
    assert os.listdir(os.path.join(pkg, "native")) == ["block_io.cc"]
    assert os.path.dirname(block_io.lib_path()) == kernels.build_dir()
    assert "build/" in open(os.path.join(REPO, ".gitignore")).read().split()


def test_entry_points_need_the_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from ace_tpu_torch.ckks.params import CkksParams
    from ace_tpu_torch.compiler.scheme_info import SchemeInfo
    from ace_tpu_torch.runtime.context import FheContext
    info = SchemeInfo(poly_degree=16, mul_level=2, first_mod_size=33,
                      scaling_mod_size=30, q_part_num=2, p_prime_num=1,
                      security_level=0, hamming_weight=0, max_msg_len=8,
                      bootstrap_depth=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FheContext(scheme_info=info)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CkksParams(degree=16, num_q=3)
    ctx = FheContext(CkksParams(degree=16, num_q=3, first_mod_size=33,
                                scaling_mod_size=30, device="cpu"))
    assert ctx.device == torch.device("cpu")


def test_kernel_wrappers_take_plain_path_only_on_cpu():
    """CPU tensors run the plain version without touching the kernel
    build; the shape check the CUDA path applies rejects a last
    dimension that is not a power of two."""
    from ace_tpu_torch.ops import pallas_modops as pm
    x = torch.zeros((2, 8), dtype=torch.int64)
    assert pm.barrett_mul(x, x, x[:, :1] + 7, x[:, :1], x[:, :1]).shape \
        == (2, 8)
    with pytest.raises(ValueError):
        pm._log2(12)
