"""The H100 exporter's Helm chart (``kube_gpu_stats_tpu_torch/deploy/helm/
kube-tpu-stats-h100``), held to the ten checks ``tests/test_helm_chart.py``
makes of the reference's chart, and to the port's raw manifests.

``helm`` is not available here, so the chart is pinned statically: its
metadata, values, every ``.Values.*`` path its templates read, balanced
braces and control blocks, the gated templates, the TLS probe switch and
the hub's shape. Parity with the raw manifests goes one step further: the
container args of the DaemonSet (and, with ``hub.enabled``, the hub) are
rendered at the chart's defaults by a small evaluator of the templates'
``if``/``with``/``range`` blocks and parse, through the port's own
parsers, to exactly what the raw ``daemonset.yaml`` and ``hub.yaml``
args parse to; mounts, volumes, environment, node selection,
tolerations, resources and security settings match too.
"""

import copy
import pathlib
import re

import pytest
import yaml

from kube_gpu_stats_tpu_torch import config, hub

DEPLOY = (pathlib.Path(__file__).resolve().parent.parent
          / "kube_gpu_stats_tpu_torch" / "deploy")
CHART = DEPLOY / "helm" / "kube-tpu-stats-h100"

_VALUES_REF = re.compile(r"\.Values\.([A-Za-z0-9_.]+)")


def template_texts():
    return {p.name: p.read_text() for p in (CHART / "templates").glob("*")}


def values():
    return yaml.safe_load((CHART / "values.yaml").read_text())


def raw(name, kind):
    (doc,) = [d for d in yaml.safe_load_all((DEPLOY / name).read_text())
              if d and d["kind"] == kind]
    return doc


# -- a small evaluator of one list block of a template ------------------------

_CONTROL = re.compile(r"^\{\{-?\s*(if|with|range|else|end)\b(.*?)-?\}\}$")
_CONDITION = re.compile(r"\s*(not\s+)?\.Values\.([\w.]+)\s*")
_ITEM = re.compile(r'^- (?:"([^"]*)"|\{\{\s*(?:toString\s+)?'
                   r'\.Values\.([\w.]+)\s*\|\s*quote\s*\}\})$')


def _lookup(vals, path):
    node = vals
    for part in path.split("."):
        node = node[part]
    return node


def render_list(text: str, key: str, vals: dict) -> list[str]:
    """The items of the first ``key:`` list in a template, rendered at
    ``vals``. Raises on a construct it cannot evaluate in a live branch."""
    lines = text.splitlines()
    start = next(i for i, line in enumerate(lines)
                 if line.strip() == f"{key}:")
    indent = len(lines[start]) - len(lines[start].lstrip())
    items, frames, active, comment = [], [], True, False
    for line in lines[start + 1:]:
        s = line.strip()
        if comment or s.startswith("{{- /*"):
            comment = "*/" not in s
            continue
        if not s or s.startswith("#"):
            continue
        control = _CONTROL.match(s)
        if control:
            word, rest = control.groups()
            if word in ("if", "with", "range"):
                cond = _CONDITION.fullmatch(rest)
                if active:
                    assert cond, f"cannot evaluate {s!r}"
                    truth = bool(_lookup(vals, cond[2])) != bool(cond[1])
                else:
                    truth = False
                frames.append([active, truth])
                active = active and truth
            elif word == "else":
                frames[-1][1] = not frames[-1][1]
                active = frames[-1][0] and frames[-1][1]
            else:
                active = frames.pop()[0]
            continue
        if len(line) - len(line.lstrip()) <= indent:
            break
        if not active or s.startswith("{{"):
            assert not active, f"cannot evaluate {s!r}"
            continue
        item = _ITEM.match(s)
        assert item, f"cannot evaluate {s!r}"
        items.append(item[1] if item[1] is not None
                     else str(_lookup(vals, item[2])))
    assert not frames, "unbalanced blocks"
    return items


def test_the_evaluator_follows_branches():
    text = "\n".join([
        "args:", '  - "a"', "  {{- if .Values.x }}", '  - "b"',
        "  {{- else }}", "  - {{ .Values.y | quote }}", "  {{- end }}",
        "  {{- with .Values.z }}", '  - "c"', "  {{- end }}", "env:"])
    assert render_list(text, "args", {"x": "", "y": 3, "z": []}) == ["a", "3"]
    assert render_list(text, "args", {"x": 1, "y": 3, "z": [1]}) == \
        ["a", "b", "c"]


# -- the reference's ten checks --------------------------------------------------

def test_chart_metadata():
    chart = yaml.safe_load((CHART / "Chart.yaml").read_text())
    assert chart["apiVersion"] == "v2"
    assert chart["name"] == "kube-tpu-stats-h100"
    assert chart["version"]
    assert chart["appVersion"]
    image = raw("daemonset.yaml", "DaemonSet")["spec"]["template"]["spec"][
        "containers"][0]["image"]
    assert image == f"{values()['image']['repository']}:" \
                    f"{values()['image']['tag']}"
    assert values()["image"]["tag"] == chart["appVersion"]


def test_values_parse():
    vals = values()
    assert vals["listenPort"] == 9400
    assert vals["backend"] == "nvml"
    assert "hostNetwork" not in vals
    assert "passthroughUnknown" not in vals


def test_every_values_reference_exists():
    vals = values()
    missing = []
    for name, text in template_texts().items():
        for ref in _VALUES_REF.findall(text):
            node = vals
            for part in ref.split("."):
                if isinstance(node, dict) and part in node:
                    node = node[part]
                else:
                    missing.append(f"{name}: .Values.{ref}")
                    break
    assert missing == [], missing


def test_template_braces_balanced():
    for name, text in template_texts().items():
        assert text.count("{{") == text.count("}}"), name


def test_daemonset_parity_with_raw_manifest():
    """At its defaults the chart's DaemonSet is the raw manifest's: the
    same args (as the port's parser reads them), host mounts, volumes,
    NVIDIA runtime environment, node selection, tolerations, resources,
    security settings and probes, and no host network."""
    ds = template_texts()["daemonset.yaml"]
    raw_ds = raw("daemonset.yaml", "DaemonSet")
    spec = raw_ds["spec"]["template"]["spec"]
    container = spec["containers"][0]
    vals = values()
    chart_args = render_list(ds, "args", vals)
    raw_args = [str(a) for a in container["args"]]
    assert config.from_args(chart_args) == config.from_args(raw_args)
    for needle in (
        "mountPath: /host/proc",
        "mountPath: /host/sys",
        "mountPath: /var/lib/kubelet/pod-resources",
        "mountPath: /var/lib/kubelet/device-plugins",
        "path: /healthz",
        "path: /readyz",
        "readOnlyRootFilesystem: true",
        "allowPrivilegeEscalation: false",
        'add: ["SYS_PTRACE"]',
    ):
        assert needle in ds, needle
    assert "hostNetwork" not in ds
    raw_text = (DEPLOY / "daemonset.yaml").read_text()
    for field in ("mountPath", "path"):
        key = re.compile(rf"^\s*(?:- )?{field}: (\S+)", re.M)
        assert set(key.findall(raw_text)) == set(key.findall(ds)), field
    assert [m.get("readOnly", False) for m in container["volumeMounts"]] \
        == [bool(re.search(rf"mountPath: {re.escape(m['mountPath'])}\n"
                           r"\s+readOnly: true", ds))
            for m in container["volumeMounts"]]
    env = {e["name"]: e for e in container["env"]}
    assert set(env) == {"NODE_NAME", "NVIDIA_VISIBLE_DEVICES",
                        "NVIDIA_DRIVER_CAPABILITIES", "KTS_ENERGY_AUDIT_KEY"}
    for name in env:
        assert f"name: {name}" in ds, name
    assert "value: utility" in ds and "value: all" in ds
    assert env["KTS_ENERGY_AUDIT_KEY"]["valueFrom"]["secretKeyRef"][
        "name"] == vals["energyAuditKeySecret"]
    assert vals["nodeSelectorTerms"] == spec["affinity"]["nodeAffinity"][
        "requiredDuringSchedulingIgnoredDuringExecution"]["nodeSelectorTerms"]
    assert vals["tolerations"] == spec["tolerations"]
    assert vals["resources"] == container["resources"]
    assert vals["hostPID"] is spec["hostPID"] is True
    assert vals["priorityClassName"] == spec["priorityClassName"]
    assert vals["listenPort"] == container["ports"][0]["containerPort"]
    assert vals["updateStrategy"]["maxUnavailable"] == \
        raw_ds["spec"]["updateStrategy"]["rollingUpdate"]["maxUnavailable"]


def test_conditional_templates_are_gated():
    texts = template_texts()
    assert texts["servicemonitor.yaml"].startswith(
        "{{- if .Values.serviceMonitor.enabled }}"
    )
    assert texts["serviceaccount.yaml"].startswith(
        "{{- if .Values.serviceAccount.create }}"
    )
    assert texts["service.yaml"].startswith("{{- if .Values.service.enabled }}")
    # The push egress stays, gated on its URL.
    ds = texts["daemonset.yaml"]
    assert ds.index("{{- if .Values.remoteWrite.url }}") < \
        ds.index('- "--remote-write-url"')
    assert values()["remoteWrite"]["url"] == ""
    assert "--remote-write-url" not in render_list(ds, "args", values())
    enabled = copy.deepcopy(values())
    enabled["remoteWrite"]["url"] = "http://tsdb:9090/api/v1/write"
    with pytest.raises(AssertionError, match="cannot evaluate"):
        render_list(ds, "args", enabled)  # the protocol's ternary


def test_hub_servicemonitor_gated_and_selector_matches_service():
    """The hub ServiceMonitor block must be gated on BOTH hub.enabled and
    serviceMonitor.enabled, and its selector must match the hub Service's
    labels."""
    text = template_texts()["hub.yaml"]
    assert ("{{- if and .Values.hub.enabled .Values.serviceMonitor.enabled }}"
            in text)
    sm_block = text.split("kind: ServiceMonitor", 1)[1]
    svc_block = text.split("kind: Service\n", 1)[1].split("---", 1)[0]
    lines = sm_block.splitlines()
    start = next(i for i, l in enumerate(lines)
                 if l.strip() == "matchLabels:")
    indent = len(lines[start]) - len(lines[start].lstrip())
    selector = []
    for line in lines[start + 1:]:
        if not line.strip() or len(line) - len(line.lstrip()) <= indent:
            break
        selector.append(line.strip())
    assert selector, "ServiceMonitor has no matchLabels entries"
    for entry in selector:
        assert entry in svc_block, entry


def test_template_control_structures_balance():
    for name, text in template_texts().items():
        opens = len(re.findall(r"\{\{-?\s*(?:if|range|with|define|block)\b",
                               text))
        ends = len(re.findall(r"\{\{-?\s*end\s*-?\}\}", text))
        assert opens == ends, (
            f"{name}: {opens} if/range/with vs {ends} end")


def test_daemonset_probe_scheme_follows_tls():
    """TLS wraps the one listener that also serves the probes: HTTPS
    probes under TLS, tcpSocket under mTLS (kubelet presents no client
    certificate)."""
    text = template_texts()["daemonset.yaml"]
    assert "scheme: HTTPS" in text
    assert "tcpSocket:" in text
    assert text.index(".Values.tls.clientCaFile") < text.index("scheme: HTTPS")


def test_hub_template_shape():
    """The optional hub runs the hub subcommand against the mounted targets
    file, carries both probes, is gated on hub.enabled (off by default),
    and with it on renders the raw hub.yaml's args, checkpoint mount,
    resources and security settings."""
    text = template_texts()["hub.yaml"]
    assert text.startswith("{{- if .Values.hub.enabled }}")
    assert '- "hub"' in text
    assert '"--targets-file"' in text
    assert "/healthz" in text and "/readyz" in text
    assert "checksum/targets" not in text
    vals = values()
    assert vals["hub"]["enabled"] is False
    assert vals["hub"]["targets"] == []
    deployment = raw("hub.yaml", "Deployment")
    pod = deployment["spec"]["template"]["spec"]
    container = pod["containers"][0]
    assert render_list(text, "args", vals) == \
        [str(a) for a in container["args"]]
    assert vals["hub"]["resources"] == container["resources"]
    assert vals["hub"]["listenPort"] == container["ports"][0][
        "containerPort"]
    for mount in container["volumeMounts"]:
        assert f"mountPath: {mount['mountPath']}" in text
    assert "runAsUser: 65532" in text and "runAsNonRoot: true" in text
    assert "readOnlyRootFilesystem: true" in text
    # A DNS-discovered hub reads no targets file.
    dns = copy.deepcopy(vals)
    dns["hub"]["targetsDns"] = "kube-tpu-stats-h100.kube-tpu-stats.svc:9400"
    args = render_list(text, "args", dns)
    assert "--targets-file" not in args
    assert args[args.index("--targets-dns") + 1] == dns["hub"]["targetsDns"]


def test_the_hub_args_parse_through_the_ports_hub_as_the_raw_ones(
        monkeypatch):
    seen = []

    class Stop(Exception):
        pass

    def fake_hub(targets, **kwargs):
        seen.append(kwargs)
        raise Stop

    class FileTargets:
        def __init__(self, path, static=()):
            self.path = path

        def __call__(self):
            return []

        def __eq__(self, other):
            return self.path == other.path

    monkeypatch.setattr(hub, "file_targets_provider", FileTargets)
    monkeypatch.setattr(hub, "Hub", fake_hub)
    raw_args = [str(a) for a in raw("hub.yaml", "Deployment")["spec"][
        "template"]["spec"]["containers"][0]["args"]]
    chart_args = render_list(template_texts()["hub.yaml"], "args", values())
    for args in (raw_args, chart_args):
        assert args[0] == "hub"
        with pytest.raises(Stop):
            hub.main(args[1:])
    plain = (str, int, float, bool, tuple, list, dict, type(None),
             FileTargets)
    settings = [{k: v for k, v in kwargs.items() if isinstance(v, plain)}
                for kwargs in seen]
    assert settings[0] == settings[1]
    assert settings[0]["targets_provider"].path == \
        "/etc/kube-tpu-stats/targets.txt"
