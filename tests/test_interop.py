"""End-to-end bridge test across the language boundary - the reference's
integration test shape (test/py_ftn_interface/test_python_fortran_interface.py:
generate, compile a real host program against the bridge, rewrite the hook
to mutate arrays, let the *host* assert it observed Python's writes), with
the Fortran host replaced by a C host."""
import os
import subprocess
import sys
import sysconfig
import textwrap

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
    # mutate through the zero-copy view: host must observe 11 * scale
    data[...] = 11.0 * scale

def nothing():
    pass
"""

C_MAIN = r"""
#include <stdio.h>
#include <stdlib.h>
#include <math.h>
#include "testbr_bridge.h"

int main(void) {
    if (testbr_bridge_init(".")) { fprintf(stderr, "init failed\n"); return 10; }

    double data[6];
    for (int i = 0; i < 6; i++) data[i] = 1.0;
    if (testbr_work(7, 2.0, data, 2, 3)) return 11;
    for (int i = 0; i < 6; i++) {
        if (fabs(data[i] - 22.0) > 1e-12) {
            fprintf(stderr, "python write not observed: %f\n", data[i]);
            return 12;
        }
    }
    if (testbr_nothing()) return 13;

    /* dual-execution validation path */
    double ref[4] = {1.0, 2.0, 3.0, 4.0};
    double good[4] = {1.0, 2.0, 3.0, 4.0};
    double bad[4] = {1.0, 2.0, 3.5, 4.0};
    if (testbr_validate_work(ref, good, 4, 1e-9) != 0) return 14;
    if (testbr_validate_work(ref, bad, 4, 1e-9) != 1) return 15;

    testbr_bridge_finalize();
    printf("BRIDGE_OK\n");
    return 0;
}
"""


@pytest.mark.skipif(
    not os.path.exists(sysconfig.get_config_var("LIBDIR") or "/nonexistent"),
    reason="no libpython available")
def test_bridge_end_to_end(tmp_path):
    from geosongpu_tpu.interop.generator import Bridge

    ydef = tmp_path / "def.yaml"
    ydef.write_text(YAML)
    bridge = Bridge.from_yaml(str(ydef))
    bridge.write(str(tmp_path))
    (tmp_path / "testbr_hook.py").write_text(HOOK)
    (tmp_path / "main.c").write_text(C_MAIN)

    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION")
    cmd = [
        "gcc", "-o", str(tmp_path / "host"), str(tmp_path / "main.c"),
        str(tmp_path / "testbr_bridge.c"),
        f"-I{inc}", f"-I{tmp_path}", f"-L{libdir}",
        f"-Wl,-rpath,{libdir}", f"-lpython{ver}", "-lm",
    ]
    r = subprocess.run(cmd, capture_output=True, text=True)
    assert r.returncode == 0, f"compile failed:\n{r.stderr}"

    env = dict(os.environ)
    env["PYTHONPATH"] = f"{tmp_path}:{env.get('PYTHONPATH', '')}"
    r = subprocess.run([str(tmp_path / "host")], capture_output=True,
                       text=True, cwd=tmp_path, env=env, timeout=120)
    assert r.returncode == 0, f"host run failed rc={r.returncode}:\n{r.stderr}\n{r.stdout}"
    assert "BRIDGE_OK" in r.stdout


def test_dycore_definition_generates(tmp_path):
    from geosongpu_tpu.interop.generator import Bridge

    src = os.path.join(os.path.dirname(__file__), "..", "geosongpu_tpu",
                       "interop", "def_dycore.yaml")
    bridge = Bridge.from_yaml(src)
    files = bridge.write(str(tmp_path))
    assert any(n.endswith("_bridge.c") for n in files)
    c = (tmp_path / "geos_jaxfv3_bridge.c").read_text()
    assert "geos_jaxfv3_run" in c and "validate_run" in c
    # the full reference state vector must be in the run signature
    h = (tmp_path / "geos_jaxfv3_bridge.h").read_text()
    for var in ("u", "v", "w", "delz", "pt", "delp", "q", "ps", "pe", "pk",
                "peln", "pkz", "phis", "q_con", "omga", "ua", "va", "uc",
                "vc", "mfx", "mfy", "cx", "cy", "diss_est"):
        assert f"float* {var}" in h, var
