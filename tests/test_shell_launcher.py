import os
import time

import pytest

from geosongpu_tpu.harness.launcher import GPUJobConfig
from geosongpu_tpu.harness.shell import ShellScript, ShellScriptError, \
    run_subprocess


def test_shellscript_write_execute(tmp_path):
    s = ShellScript("hello", str(tmp_path))
    s.write(["echo WORLD_$((40+2))"], exports={"FOO": "bar"})
    out = s.execute()
    assert "WORLD_42" in out
    content = open(s.path).read()
    assert "export FOO=bar" in content and "set -euo pipefail" in content


def test_shellscript_failure_raises(tmp_path):
    s = ShellScript("boom", str(tmp_path))
    s.write(["exit 3"])
    with pytest.raises(ShellScriptError):
        s.execute()


def test_shellscript_detached_and_poll(tmp_path):
    s = ShellScript("bg", str(tmp_path))
    s.write(["sleep 0.5", "echo done"])
    pid = s.execute_detached()
    ShellScript.wait_for_pid(pid, poll_s=0.2, timeout_s=10)
    log = open(os.path.join(str(tmp_path), "bg.log")).read()
    assert "done" in log


def test_job_config_layouts_and_env():
    one = GPUJobConfig.one_gpu()
    assert one.total_gpus == 1
    host = GPUJobConfig.one_host_4gpu()
    assert host.total_gpus == 4
    two = GPUJobConfig.two_hosts_4gpu()
    assert two.total_gpus == 8
    env = two.launch_env(process_id=1)
    assert env["JAX_NUM_PROCESSES"] == "2"
    assert env["JAX_PROCESS_ID"] == "1"
    # single host: no distributed env
    assert "JAX_NUM_PROCESSES" not in host.launch_env(0)


def test_wrapper_script_brackets_with_sampler(tmp_path):
    cfg = GPUJobConfig(hosts=1, gpus_per_host=1, hardware_sampling=True)
    script = cfg.wrapper_script(["echo payload"], name="wrap",
                                wd=str(tmp_path))
    content = open(script.path).read()
    assert content.index("client start") < content.index("echo payload")
    assert content.index("echo payload") < content.index("client dump")
