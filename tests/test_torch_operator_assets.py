"""The H100 exporter's operator assets (``kube_gpu_stats_tpu_torch/deploy/``):
the Grafana board, the alert and recording rules, the PodMonitors and the
bare-host systemd unit, checked as ``tests/test_deploy_assets.py`` checks
the reference's, and held to the reference's assets: every reference
alert is carried over under its name (same expression, severity and
``for:``) or listed in ``assets.NOT_ON_H100``, every recording rule and
board family is carried or absent on H100 (``FAMILIES_NOT_ON_H100``), and
no asset names a family outside the port's schema or a TPU-only surface.
The metric-token check covers every family prefix of the port's schema.
"""

import configparser
import json
import pathlib
import re
import runpy
import shutil

import pytest
import yaml

from kube_gpu_stats_tpu_torch import config, schema, topology
from kube_gpu_stats_tpu_torch.collectors.nvml import NvmlCollector
from kube_gpu_stats_tpu_torch.deploy import assets
from kube_gpu_stats_tpu_torch.testing.fake_nvml import FakeDevice, FakeNvml

ROOT = pathlib.Path(__file__).resolve().parent.parent
DEPLOY = ROOT / "kube_gpu_stats_tpu_torch" / "deploy"
REF_DEPLOY = ROOT / "deploy"
SYSTEMD = DEPLOY / "systemd"
UNIT = "kube-tpu-stats-h100"


def load_yaml_docs(name):
    return [d for d in yaml.safe_load_all((DEPLOY / name).read_text()) if d]


def _rules(path: pathlib.Path) -> list[dict]:
    doc = yaml.safe_load(path.read_text())
    return [r for g in doc["groups"] for r in g["rules"]]


def known_exposition_names():
    names = set()
    for spec in schema.ALL_METRICS:
        names.add(spec.name)
        if spec.type is schema.MetricType.HISTOGRAM:
            names.update(
                {f"{spec.name}_bucket", f"{spec.name}_sum", f"{spec.name}_count"}
            )
    return names


def _tokens(text: str) -> list[str]:
    return assets.FAMILY_TOKEN.findall(text)


def _normal(expr: str) -> str:
    return " ".join(expr.split())


def test_the_metric_token_covers_every_family_prefix_of_the_schema():
    prefixes = {spec.name.split("_", 1)[0] for spec in schema.ALL_METRICS
                if spec.name != "tpu_runtime_passthrough"}
    assert prefixes == {"accelerator", "collector", "kts", "slice",
                        "process", "hub"}
    for name in known_exposition_names() - {"tpu_runtime_passthrough"}:
        assert _tokens(f"rate({name}[5m])") == [name], name
        assert assets.family_of(name) is not None, name
    assert assets.family_of("kts_no_such_family") is None


# -- the Grafana board ------------------------------------------------------------

def test_dashboard_json_matches_builder(tmp_path):
    """dashboard.json must be exactly what build_dashboard.py generates:
    edit the builder, regenerate, commit both. The builder is stdlib only
    (it runs from a copy in an empty directory)."""
    build = tmp_path / "build_dashboard.py"
    shutil.copy(DEPLOY / "grafana" / "build_dashboard.py", build)
    runpy.run_path(str(build), run_name="__main__")
    assert (tmp_path / "dashboard.json").read_text() == \
        (DEPLOY / "grafana" / "dashboard.json").read_text()


def test_dashboard_references_only_real_metrics():
    known = known_exposition_names()
    exprs = assets.expressions()["dashboard"]
    assert exprs, "dashboard has no queries"
    for expr in exprs:
        for token in _tokens(expr):
            assert token in known, f"dashboard references unknown metric {token}"


def test_dashboard_chip_colors_fixed_order_not_cycled():
    board = assets.dashboard()

    def color_overrides(panel):
        return [
            o["properties"][0]["value"]["fixedColor"]
            for o in panel.get("fieldConfig", {}).get("overrides", [])
            if o["properties"][0]["id"] == "color"
        ]

    per_card_panels = [p for p in board["panels"] if color_overrides(p)]
    assert per_card_panels
    first = color_overrides(per_card_panels[0])
    assert len(first) == len(set(first)) == 8  # an HGX H100 node's cards
    for panel in per_card_panels[1:]:
        assert color_overrides(panel) == first
    reference = json.loads(
        (REF_DEPLOY / "grafana" / "dashboard.json").read_text())
    ref_first = next(color_overrides(p) for p in reference["panels"]
                     if color_overrides(p))
    assert first == ref_first


def test_dashboard_template_vars():
    board = assets.dashboard()
    names = [v["name"] for v in board["templating"]["list"]]
    assert names == ["datasource", "slice", "worker", "accel_type"]


def test_every_reference_board_family_is_carried_or_absent_on_h100():
    reference = json.loads(
        (REF_DEPLOY / "grafana" / "dashboard.json").read_text())
    ref_families = {assets.family_of(token)
                    for panel in reference["panels"]
                    for target in panel.get("targets", [])
                    for token in _tokens(target["expr"])}
    ours = assets.named_families()["dashboard"]
    assert ours <= ref_families  # the port adds no family
    assert ref_families - ours == \
        ref_families & set(assets.FAMILIES_NOT_ON_H100)
    assert len(assets.dashboard()["panels"]) == \
        len(reference["panels"]) - 2  # the DCN and collective panels


# -- the rule files --------------------------------------------------------------

def test_alert_rules_parse_and_reference_real_metrics():
    rules = assets.alert_rules()
    assert len(rules) >= 4
    known = known_exposition_names()
    for rule in rules:
        assert "alert" in rule and "expr" in rule
        for text in (rule["expr"], *rule.get("annotations", {}).values()):
            for token in _tokens(text):
                assert token in known, \
                    f"{rule['alert']} references unknown metric {token}"
        assert rule.get("labels", {}).get("severity") in ("warning", "critical")


def test_recording_rules_parse_and_reference_real_metrics():
    rules = assets.recording_rules()
    assert len(rules) >= 5
    known = known_exposition_names()
    for rule in rules:
        assert "record" in rule and "expr" in rule
        for token in _tokens(rule["expr"]):
            assert token in known, f"recording rule references unknown {token}"


def test_every_reference_alert_is_carried_or_not_on_h100():
    reference = {r["alert"]: r for r in _rules(REF_DEPLOY / "alerts.yaml")}
    ours = {r["alert"]: r for r in assets.alert_rules()}
    assert len(ours) == len(assets.alert_rules())  # no name twice
    assert set(ours) | set(assets.NOT_ON_H100) == set(reference)
    assert set(ours) & set(assets.NOT_ON_H100) == set()
    for name, rule in ours.items():
        ref = reference[name]
        assert rule["labels"]["severity"] == ref["labels"]["severity"], name
        assert rule.get("for") == ref.get("for"), name
        want = ref["expr"].replace('resource="google.com/tpu"',
                                   'resource="nvidia.com/gpu"')
        assert _normal(rule["expr"]) == _normal(want), name
        assert rule["annotations"]["summary"], name


def test_every_reference_recording_rule_is_carried_or_on_an_absent_family():
    reference = {r["record"]: r
                 for r in _rules(REF_DEPLOY / "recording_rules.yaml")}
    ours = {r["record"]: r for r in assets.recording_rules()}
    assert set(ours) <= set(reference)
    for name, rule in reference.items():
        families = {assets.family_of(t) for t in _tokens(rule["expr"])}
        if name in ours:
            assert _normal(ours[name]["expr"]) == _normal(rule["expr"])
            assert not families & set(assets.FAMILIES_NOT_ON_H100), name
        else:
            assert families & set(assets.FAMILIES_NOT_ON_H100), name


def test_no_asset_names_a_family_not_on_h100_and_conditionals_are_named():
    named = set().union(*assets.named_families().values())
    assert named & set(assets.FAMILIES_NOT_ON_H100) == set()
    known = {spec.name for spec in schema.ALL_METRICS}
    assert set(assets.CONDITIONAL) <= known
    assert set(assets.FAMILIES_NOT_ON_H100) <= known
    assert set(assets.CONDITIONAL) <= named  # each entry is needed
    assert set(assets.CONDITIONAL) & set(assets.FAMILIES_NOT_ON_H100) == set()
    # Each family left out is one a reference asset names.
    reference = json.loads(
        (REF_DEPLOY / "grafana" / "dashboard.json").read_text())
    ref_exprs = [t["expr"] for p in reference["panels"]
                 for t in p.get("targets", [])]
    ref_exprs += [r["expr"] for name in ("alerts.yaml", "recording_rules.yaml")
                  for r in _rules(REF_DEPLOY / name)]
    ref_named = {assets.family_of(t) for e in ref_exprs for t in _tokens(e)}
    assert set(assets.FAMILIES_NOT_ON_H100) <= ref_named


def test_the_not_on_h100_reasons_hold_in_the_port():
    """Each alert left out is confirmed from the port's collector, flags
    and link localizer."""
    assert set(assets.NOT_ON_H100) == {
        "AcceleratorRuntimeRestarted", "AcceleratorDcnLatencyHigh",
        "AcceleratorPassthroughFamilyCap", "FleetIciLinkSuspect"}
    dev = FakeDevice(uuid="GPU-0", minor=0, gpu_util=50,
                     nvlink_kib={0: (5, 5)}, gpm_supported=True)
    collector = NvmlCollector(FakeNvml([dev]))
    try:
        (card,) = collector.discover()
        samples = [collector.sample(card) for _ in range(2)]
    finally:
        collector.close()
    for sample in samples:
        names = set(sample.values)
        assert schema.UPTIME.name not in names  # no restart can be seen
        assert not any(n.startswith(schema.DCN_LATENCY.name) for n in names)
        assert sample.collective_ops is None
        assert dict(sample.raw_values) == {}  # nothing passes through
    flags = {o for a in config.build_parser()._actions
             for o in a.option_strings}
    assert "--passthrough-unknown" not in flags
    graph = topology.InterconnectGraph(["0", "1", "2", "3"], "2x2")
    assert graph.edge_for("0", "x1") is not None
    assert all(graph.edge_for("0", f"nvlink{link}") is None
               for link in range(18))


# Terms of the reference's TPU surfaces that no functional line of an
# H100 asset may carry. The port's own --sysfs-root flag (thermal zones
# and NICs under /sys) is a host surface of the port, not the TPU driver's
# sysfs, and is taken out before the check.
TPU_TERMS = ("libtpu", "sysfs", "/dev/accel", "gke-tpu", "google.com/tpu",
             "tpu vm", "tpu_runtime", "passthrough")
TPU_WORDS = re.compile(r"\b(TPU|ICI|DCN|MXU)\b")
NEW_ASSETS = ("alerts.yaml", "recording_rules.yaml", "podmonitor.yaml",
              "kustomization.yaml", "grafana/dashboard.json",
              "systemd/kube-tpu-stats-h100.service",
              "systemd/kube-tpu-stats-h100.env", "systemd/install.sh",
              *(str(p.relative_to(DEPLOY)) for p in
                sorted((DEPLOY / "helm").rglob("*")) if p.is_file()))


def _functional_lines(path: pathlib.Path) -> str:
    lines = [line for line in path.read_text().splitlines()
             if not line.lstrip().startswith(("#", "{{- /*", "*/"))]
    return "\n".join(lines).replace("--sysfs-root", "--host-sys-root")


@pytest.mark.parametrize("name", NEW_ASSETS)
def test_no_asset_line_names_a_tpu_surface(name):
    functional = _functional_lines(DEPLOY / name)
    for term in TPU_TERMS:
        assert term not in functional.lower(), (name, term)
    assert TPU_WORDS.findall(functional) == [], name


# -- the PodMonitors and the kustomization -------------------------------------

def test_podmonitor_matches_daemonset():
    """The optional prometheus-operator PodMonitors must select the pods
    they claim (DaemonSet and hub) and scrape the port the container
    actually names."""
    docs = load_yaml_docs("podmonitor.yaml")
    assert [d["kind"] for d in docs] == ["PodMonitor", "PodMonitor"]
    by_name = {d["metadata"]["name"]: d for d in docs}
    pm = by_name["kube-tpu-stats-h100"]
    (ds,) = [d for d in load_yaml_docs("daemonset.yaml")
             if d["kind"] == "DaemonSet"]
    pod_labels = ds["spec"]["template"]["metadata"]["labels"]
    for key, value in pm["spec"]["selector"]["matchLabels"].items():
        assert pod_labels.get(key) == value
    container = ds["spec"]["template"]["spec"]["containers"][0]
    port_names = {p["name"] for p in container["ports"]}
    for endpoint in pm["spec"]["podMetricsEndpoints"]:
        assert endpoint["port"] in port_names
        assert endpoint.get("path", "/metrics") == "/metrics"
    assert pm["metadata"]["namespace"] == ds["metadata"]["namespace"]

    hub_pm = by_name["kube-tpu-stats-h100-hub"]
    (dep,) = [d for d in load_yaml_docs("hub.yaml")
              if d["kind"] == "Deployment"]
    hub_labels = dep["spec"]["template"]["metadata"]["labels"]
    for key, value in hub_pm["spec"]["selector"]["matchLabels"].items():
        assert hub_labels.get(key) == value
    hub_ports = {p["name"] for c in
                 dep["spec"]["template"]["spec"]["containers"]
                 for p in c["ports"]}
    for endpoint in hub_pm["spec"]["podMetricsEndpoints"]:
        assert endpoint["port"] in hub_ports
    assert hub_pm["metadata"]["namespace"] == dep["metadata"]["namespace"]


def test_kustomization_names_what_it_leaves_out():
    """The rule files and the PodMonitors are named beside the resources,
    as the reference's kustomization names its rule file, and every named
    file exists."""
    text = (DEPLOY / "kustomization.yaml").read_text()
    (doc,) = load_yaml_docs("kustomization.yaml")
    for name in ("alerts.yaml", "recording_rules.yaml", "podmonitor.yaml",
                 "grafana/dashboard.json"):
        assert name in text and name not in doc["resources"]
        assert (DEPLOY / name).is_file()
    assert (DEPLOY / "helm" / "kube-tpu-stats-h100").is_dir()


# -- the bare-host systemd unit ------------------------------------------------

def _unit():
    parser = configparser.ConfigParser(strict=True)
    parser.read_string((SYSTEMD / f"{UNIT}.service").read_text())
    return parser


def test_systemd_unit_shape():
    """The bare-host (DGX outside Kubernetes) unit parses as INI, restarts
    on failure, runs the port's NVML daemon, and its hardening hides
    neither NVML's device nodes nor the holder scan's /proc."""
    parser = _unit()
    service = parser["Service"]
    assert service["ExecStart"].endswith(
        "python3 -m kube_gpu_stats_tpu_torch --backend nvml")
    assert service["Restart"] == "always"
    assert service["EnvironmentFile"].lstrip("-") == f"/etc/default/{UNIT}"
    assert service["ProtectSystem"] == "strict"
    assert "textfile_collector" in service["ReadWritePaths"]
    assert "PrivateDevices" not in service  # /dev/nvidiactl, /dev/nvidia<N>
    assert service.get("ProtectProc", "default") != "invisible"
    assert "DevicePolicy" not in service
    assert parser["Install"]["WantedBy"] == "multi-user.target"
    # The energy checkpoint's directory is the unit's state directory.
    env = (SYSTEMD / f"{UNIT}.env").read_text()
    checkpoint = re.search(r"^KTS_ENERGY_CHECKPOINT=(\S+)$", env, re.M)[1]
    assert checkpoint.startswith(f"/var/lib/{service['StateDirectory']}/")


def test_systemd_env_file_keys_are_real_flags():
    """Every KTS_* key in the env file (set or commented) is a flag of the
    port's config.build_parser or a variable the port reads itself."""
    dests = {"KTS_" + a.dest.upper()
             for a in config.build_parser()._actions if a.dest != "help"}
    topology_src = pathlib.Path(topology.__file__).read_text()
    own = {"KTS_SLICE", "KTS_WORKER", "KTS_TOPOLOGY"}
    for key in own:
        assert f'"{key}"' in topology_src, key
    assert "KTS_NO_NATIVE" in dests
    keys = []
    for line in (SYSTEMD / f"{UNIT}.env").read_text().splitlines():
        line = line.strip().lstrip("# ")
        if "=" in line and line.split("=")[0].startswith("KTS_"):
            keys.append(line.split("=")[0])
    assert keys
    for key in keys:
        assert key in dests | own, f"env file sets unknown variable {key}"
    cfg_env = {k: v for k, v in (
        line.split("=", 1) for line in
        (SYSTEMD / f"{UNIT}.env").read_text().splitlines()
        if line.startswith("KTS_"))}
    assert cfg_env["KTS_ATTRIBUTION"] == "off"


def test_systemd_installer_references_shipped_files():
    text = (SYSTEMD / "install.sh").read_text()
    assert "set -euo pipefail" in text
    for shipped in (f"{UNIT}.service", f"{UNIT}.env"):
        assert shipped in text
        assert (SYSTEMD / shipped).exists()
    # The unit's package directory is read-only under ProtectSystem, so
    # the host fast paths are built at install time, and a failed build
    # fails the install (no `|| true`).
    assert "python3 -m kube_gpu_stats_tpu_torch.native._hostbuild" in text
    build = next(line for line in text.splitlines()
                 if "native._hostbuild" in line)
    assert "||" not in build
    assert "kube-tpu-stats-h100 doctor" in text  # preflight after install
