"""Fortran side of the bridge: generated bind(c) module + dual-execution
validation subroutines (parity with the reference's
templates/interface.f90.jinja2:39,111-167 and its end-to-end test
test/py_ftn_interface/test_python_fortran_interface.py:11-78).

The container image has no Fortran compiler, so the compile-and-run test
self-skips when gfortran is absent; the structural test always runs and
the C-host test (test_interop.py) covers the embedded-Python runtime.
"""
import os
import shutil
import subprocess
import sysconfig

import pytest

YAML = """\
name: testbr
functions:
  work:
    validation: true
    inputs:
      n: int
      scale: double
    inouts:
      data: {type: array_double, rank: 2}
  nothing: {}
"""

HOOK = """\
import numpy as np

def work(n=None, scale=None, data=None):
    data[...] = 11.0 * scale

def nothing():
    pass
"""

F90_MAIN = """\
program host
    use iso_c_binding, only: c_double, c_int
    use testbr_interface_mod
    implicit none
    real(c_double) :: data(2, 3)
    integer :: rc
    rc = testbr_bridge_init_f(".")
    if (rc /= 0) stop 10

    data = 1.0_c_double
    call testbr_work_f(7, 2.0_c_double, data, rc)
    if (rc /= 0) stop 11
    if (any(abs(data - 22.0_c_double) > 1e-12_c_double)) stop 12

    ! dual execution: reference impl matches python -> rc == 0
    data = 1.0_c_double
    call validate_testbr_work_f(7, 2.0_c_double, data, ref_good, &
                                1e-9_c_double, rc)
    if (rc /= 0) stop 13
    if (any(abs(data - 22.0_c_double) > 1e-12_c_double)) stop 14

    ! reference impl disagrees -> rc /= 0
    data = 1.0_c_double
    call validate_testbr_work_f(7, 2.0_c_double, data, ref_bad, &
                                1e-9_c_double, rc)
    if (rc == 0) stop 15

    call testbr_bridge_finalize_f()
    print *, "F90_BRIDGE_OK"
contains
    subroutine ref_good(n, scale, data)
        use iso_c_binding, only: c_int, c_double
        integer(c_int), intent(in) :: n
        real(c_double), intent(in) :: scale
        real(c_double), intent(inout), contiguous :: data(:, :)
        data = 11.0_c_double * scale
    end subroutine ref_good
    subroutine ref_bad(n, scale, data)
        use iso_c_binding, only: c_int, c_double
        integer(c_int), intent(in) :: n
        real(c_double), intent(in) :: scale
        real(c_double), intent(inout), contiguous :: data(:, :)
        data = 999.0_c_double
    end subroutine ref_bad
end program host
"""


@pytest.fixture
def bridge_dir(tmp_path):
    from geosongpu_tpu.interop.generator import Bridge

    ydef = tmp_path / "def.yaml"
    ydef.write_text(YAML)
    Bridge.from_yaml(str(ydef)).write(str(tmp_path))
    return tmp_path


def test_f90_module_structure(bridge_dir):
    src = (bridge_dir / "testbr_interface.f90").read_text()
    # bind(c) names must match the C trampolines exactly
    assert "bind(c, name='testbr_work')" in src
    assert "bind(c, name='testbr_validate_work')" in src
    assert "bind(c, name='testbr_bridge_init')" in src
    # typed wrapper with assumed-shape dummy
    assert "subroutine testbr_work_f(n, scale, data, rc)" in src
    assert "contiguous, target :: data(:, :)" in src
    # dims reversed so the C-order numpy view matches column-major memory
    assert "int(size(data, 2), c_int), int(size(data, 1), c_int)" in src
    # dual-execution validation: deep copies + reference procedure arg
    assert "validate_testbr_work_f" in src
    assert "data_fref = data" in src and "data_py = data" in src
    assert "call ref_impl(n, scale, data_fref)" in src
    # python result is the production path: written back to the caller
    assert "data = data_py" in src


def test_f90_dycore_definition_generates(tmp_path):
    from geosongpu_tpu.interop.generator import Bridge

    src = os.path.join(os.path.dirname(__file__), "..", "geosongpu_tpu",
                       "interop", "def_dycore.yaml")
    Bridge.from_yaml(src).write(str(tmp_path))
    f90 = (tmp_path / "geos_jaxfv3_interface.f90").read_text()
    for var in ("u", "v", "w", "delz", "pt", "delp", "ps", "pe", "pk",
                "peln", "pkz", "phis", "omga", "ua", "va", "uc", "vc",
                "mfx", "mfy"):
        assert f":: {var}(" in f90, var


@pytest.mark.skipif(shutil.which("gfortran") is None,
                    reason="no Fortran compiler in this image")
def test_f90_bridge_end_to_end(bridge_dir):
    """Mirror of the C-host end-to-end test with a real Fortran host:
    Fortran observes Python's writes; the dual-execution validate pass
    and fail cases both behave."""
    (bridge_dir / "testbr_hook.py").write_text(HOOK)
    (bridge_dir / "main.f90").write_text(F90_MAIN)

    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION")
    cmd = [
        "gfortran", "-o", str(bridge_dir / "host"),
        str(bridge_dir / "testbr_interface.f90"),
        str(bridge_dir / "main.f90"),
        str(bridge_dir / "testbr_bridge.c"),
        f"-I{inc}", f"-L{libdir}", f"-Wl,-rpath,{libdir}",
        f"-lpython{ver}", "-lm",
    ]
    r = subprocess.run(cmd, capture_output=True, text=True,
                       cwd=bridge_dir)
    assert r.returncode == 0, f"compile failed:\n{r.stderr}"

    env = dict(os.environ)
    env["PYTHONPATH"] = f"{bridge_dir}:{env.get('PYTHONPATH', '')}"
    r = subprocess.run([str(bridge_dir / "host")], capture_output=True,
                       text=True, cwd=bridge_dir, env=env, timeout=120)
    assert r.returncode == 0, (r.returncode, r.stderr, r.stdout)
    assert "F90_BRIDGE_OK" in r.stdout
