"""The port's operator plane (``deploy/torch/``) and its fault-injection
skill (``skills/torch/``).

- Every systemd unit's ``ExecStart`` and every service command of
  ``compose.yaml`` names a ``tpu_resiliency_torch`` module with the same
  ports and flags as the JAX package's ``deploy/`` (file for file); each
  module runs with ``--help`` to exit 0 and lists every flag the command
  passes.
- ``skills/torch/score_attribution.py --quick --device cpu`` runs its three
  scenarios through the port's launcher and scores every failed cycle's
  log right (its accuracy line reads 1.0).
"""

import json
import os
import re
import shlex
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "deploy" / "torch"
JAX = REPO / "deploy"


def _unit_commands(root: Path, pattern: str) -> dict:
    cmds = {}
    for unit in sorted((root / "systemd").glob(pattern)):
        line = re.search(r"^ExecStart=(.*)$", unit.read_text(), re.M).group(1)
        cmds[unit.name] = shlex.split(line)
    return cmds


def _compose_commands(path: Path) -> dict:
    """``service -> argv`` of a compose file's folded ``command:`` scalars
    (a service's command is its ``command:`` line and the more-indented
    lines after it)."""
    cmds, service, cmd, indent = {}, None, None, 0
    for line in path.read_text().splitlines():
        m = re.match(r"^  (\S[^:]*):\s*$", line)
        if m:
            service = m.group(1)
            continue
        m = re.match(r"^(\s+)command:\s*(.*)$", line)
        if m:
            indent, cmd = len(m.group(1)), [m.group(2)]
            cmds[service] = cmd
            continue
        if cmd is not None and line.strip() and len(line) - len(line.lstrip()) > indent:
            cmd.append(line.strip())
        else:
            cmd = None
    return {svc: shlex.split(" ".join(parts)) for svc, parts in cmds.items()}


def _module_and_flags(argv: list) -> tuple:
    i = argv.index("-m")
    return argv[i + 1], argv[i + 2:]


def test_deploy_commands_name_the_port_with_the_same_flags():
    port_units = _unit_commands(PORT, "tpurx-torch-*.service")
    jax_units = _unit_commands(JAX, "tpurx-*.service")
    assert sorted(port_units) == sorted(
        n.replace("tpurx-", "tpurx-torch-") for n in jax_units)
    port_compose = _compose_commands(PORT / "compose.yaml")
    jax_compose = _compose_commands(JAX / "compose.yaml")
    assert sorted(port_compose) == sorted(jax_compose) == [
        "attrsvc", "control-plane", "smonsvc"]
    pairs = [(port_units[n.replace("tpurx-", "tpurx-torch-")], jax_units[n])
             for n in jax_units]
    pairs += [(port_compose[s], jax_compose[s]) for s in jax_compose]
    helps = {}
    for port_argv, jax_argv in pairs:
        mod, flags = _module_and_flags(port_argv)
        jmod, jflags = _module_and_flags(jax_argv)
        assert mod == jmod.replace("tpu_resiliency.", "tpu_resiliency_torch.", 1)
        assert flags == jflags
        if mod not in helps:
            proc = subprocess.run([sys.executable, "-m", mod, "--help"], cwd=str(REPO),
                                  capture_output=True, text=True, timeout=120)
            assert proc.returncode == 0, (mod, proc.stderr[-2000:])
            helps[mod] = proc.stdout
        for flag in (f for f in flags if f.startswith("--")):
            assert flag in helps[mod], (mod, flag)
    assert sorted(helps) == [
        "tpu_resiliency_torch.fault_tolerance.control_plane",
        "tpu_resiliency_torch.services.attrsvc",
        "tpu_resiliency_torch.services.smonsvc",
    ]
    readme = (PORT / "README.md").read_text()
    assert "python -m tpu_resiliency_torch.fault_tolerance.launcher" in readme
    assert "tpu_resiliency." not in readme.replace("tpu_resiliency_torch", "")


def test_score_attribution_quick_on_the_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(REPO / "skills" / "torch" / "score_attribution.py"),
         "--quick", "--device", "cpu"],
        cwd=str(REPO), capture_output=True, text=True, timeout=400,
        env={**os.environ, "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
    assert line["metric"] == "attribution_accuracy"
    assert (line["value"], line["correct"], line["total"]) == (1.0, 3, 3)
    assert proc.stdout.count("[PASS]") == 3
