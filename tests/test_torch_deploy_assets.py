"""The port's deployment assets (``kube_gpu_stats_tpu_torch/deploy/``),
checked the way ``tests/test_deploy_assets.py`` checks the reference's:
every manifest parses as YAML, the DaemonSet has the reference's shape
adapted to an NVIDIA node (GPU node affinity, probes, hostPID, read-only
host mounts, ``--backend nvml``) and passes only flags the port's daemon
accepts, the images run as a non-root user with the expected entry
points, and the exporter's image carries no CUDA userspace.
"""

import pathlib
import re

import pytest
import yaml

from kube_gpu_stats_tpu_torch import config
from kube_gpu_stats_tpu_torch.loadgen import burn

DEPLOY = (pathlib.Path(__file__).resolve().parent.parent
          / "kube_gpu_stats_tpu_torch" / "deploy")
MANIFESTS = ("daemonset.yaml", "rbac.yaml", "kustomization.yaml",
             "loadgen-job.yaml")


def load_yaml_docs(name):
    return [d for d in yaml.safe_load_all((DEPLOY / name).read_text()) if d]


def _daemonset_spec():
    (ds,) = load_yaml_docs("daemonset.yaml")
    assert ds["kind"] == "DaemonSet"
    return ds, ds["spec"]["template"]["spec"]


def _functional(name: str) -> str:
    """The file without its comment lines (prose may name what it
    leaves out)."""
    return "\n".join(line for line in (DEPLOY / name).read_text()
                     .splitlines() if not line.lstrip().startswith("#"))


@pytest.mark.parametrize("name", MANIFESTS)
def test_every_manifest_parses(name):
    docs = load_yaml_docs(name)
    assert docs and all("kind" in doc for doc in docs)


def test_kustomization_lists_the_exporter_manifests():
    (kustomization,) = load_yaml_docs("kustomization.yaml")
    assert kustomization["resources"] == ["rbac.yaml", "daemonset.yaml",
                                          "hub.yaml"]
    for resource in kustomization["resources"]:
        assert (DEPLOY / resource).is_file()


def test_daemonset_schedules_on_gpu_nodes():
    _, spec = _daemonset_spec()
    terms = spec["affinity"]["nodeAffinity"][
        "requiredDuringSchedulingIgnoredDuringExecution"]["nodeSelectorTerms"]
    exprs = [e for t in terms for e in t["matchExpressions"]]
    assert {"key": "nvidia.com/gpu.present", "operator": "In",
            "values": ["true"]} in exprs
    assert "nodeSelector" not in spec
    assert any(t["key"] == "nvidia.com/gpu" for t in spec["tolerations"])
    # The exporter takes no card from the workloads it watches.
    resources = spec["containers"][0]["resources"]
    assert "nvidia.com/gpu" not in str(resources)
    assert resources["requests"] and resources["limits"]


def test_daemonset_probes_ports_and_security():
    _, spec = _daemonset_spec()
    assert spec["hostPID"] is True
    assert not spec.get("hostNetwork")  # NVML needs no node loopback
    container = spec["containers"][0]
    assert container["ports"][0]["containerPort"] == 9400
    assert container["livenessProbe"]["httpGet"]["path"] == "/healthz"
    assert container["readinessProbe"]["httpGet"]["path"] == "/readyz"
    security = container["securityContext"]
    assert security["readOnlyRootFilesystem"] is True
    assert security["allowPrivilegeEscalation"] is False
    assert security["capabilities"]["drop"] == ["ALL"]


def _args() -> list[str]:
    _, spec = _daemonset_spec()
    return [str(arg) for arg in spec["containers"][0]["args"]]


def _flag_value(args: list[str], flag: str) -> str:
    return args[args.index(flag) + 1]


def test_daemonset_mounts_the_host_read_only_where_its_flags_point():
    _, spec = _daemonset_spec()
    mounts = {m["mountPath"]: m for m in spec["containers"][0]["volumeMounts"]}
    volumes = {v["name"]: v for v in spec["volumes"]}
    args = _args()
    host = {"--proc-root": "/proc", "--sysfs-root": "/sys",
            "--cgroup-root": "/sys/fs/cgroup"}
    for flag, host_path in host.items():
        mount = mounts[_flag_value(args, flag)]
        assert mount["readOnly"] is True, flag
        assert volumes[mount["name"]]["hostPath"]["path"] == host_path
    for path in ("/var/lib/kubelet/pod-resources",
                 "/var/lib/kubelet/device-plugins"):
        assert mounts[path]["readOnly"] is True
        assert volumes[mounts[path]["name"]]["hostPath"]["path"] == path
    # The defaults of the attribution flags live under those mounts.
    assert config.DEFAULT_KUBELET_SOCKET.startswith(
        "/var/lib/kubelet/pod-resources/")
    assert config.DEFAULT_CHECKPOINT.startswith(
        "/var/lib/kubelet/device-plugins/")
    # Every host mount is read-only; the one writable mount holds the
    # energy checkpoint.
    writable = [path for path, m in mounts.items() if not m.get("readOnly")]
    assert writable == ["/var/lib/kube-tpu-stats"]
    assert _flag_value(args, "--energy-checkpoint").startswith(
        "/var/lib/kube-tpu-stats/")
    assert "emptyDir" in volumes[mounts["/var/lib/kube-tpu-stats"]["name"]]


def test_daemonset_flags_are_the_ports():
    args = _args()
    assert _flag_value(args, "--backend") == "nvml"
    cfg = config.from_args(args)
    assert (cfg.backend, cfg.listen_port, cfg.proc_root, cfg.sysfs_root,
            cfg.cgroup_root) == ("nvml", 9400, "/host/proc", "/host/sys",
                                 "/host/sys/fs/cgroup")
    # The environment it sets is the port's own (KTS_*) or the NVIDIA
    # container runtime's.
    _, spec = _daemonset_spec()
    for env in spec["containers"][0]["env"]:
        assert env["name"] in ("NODE_NAME", "NVIDIA_VISIBLE_DEVICES",
                               "NVIDIA_DRIVER_CAPABILITIES",
                               "KTS_ENERGY_AUDIT_KEY"), env["name"]


def test_the_commented_burst_mode_choice_is_a_real_flag():
    commented = re.findall(r"^\s*#\s*-\s*(\S+)\s*$",
                           (DEPLOY / "daemonset.yaml").read_text(), re.M)
    assert commented == ["--burst-mode", "continuous"]
    assert config.from_args(_args() + commented).burst_mode == "continuous"


def test_dockerfile_entrypoint_user_and_no_cuda_userspace():
    text = (DEPLOY / "Dockerfile").read_text()
    assert "FROM python:3.12-slim" in text
    assert 'ENTRYPOINT ["python", "-m", "kube_gpu_stats_tpu_torch"]' in text
    assert "USER 65532" in text and "EXPOSE 9400" in text
    functional = _functional("Dockerfile").lower()
    assert functional.count("from ") == 1  # one stage, no toolchain
    for needle in ("cuda-", "nvidia/cuda", "libnvidia", "nvcc", "torch ",
                   "pip install torch", "libcudnn", "cublas"):
        assert needle not in functional, needle
    # The container runtime injects NVML when asked for the utility
    # capability; nothing in the image provides it.
    assert "NVIDIA_DRIVER_CAPABILITIES=utility" in text


def test_rbac_and_service():
    docs = load_yaml_docs("rbac.yaml")
    assert [d["kind"] for d in docs] == ["Namespace", "ServiceAccount",
                                         "Service"]
    service = docs[2]
    assert service["spec"]["clusterIP"] == "None"
    assert service["spec"]["ports"][0]["port"] == 9400
    _, spec = _daemonset_spec()
    assert spec["serviceAccountName"] == docs[1]["metadata"]["name"]
    assert service["spec"]["selector"] == \
        load_yaml_docs("daemonset.yaml")[0]["spec"]["selector"][
            "matchLabels"]


def test_loadgen_job_burns_one_card_with_the_cuda_kernel():
    (job,) = load_yaml_docs("loadgen-job.yaml")
    assert job["kind"] == "Job"
    (container,) = job["spec"]["template"]["spec"]["containers"]
    assert container["resources"]["limits"] == {"nvidia.com/gpu": 1}
    args = burn.build_parser().parse_args(
        [str(arg) for arg in container["args"]])
    assert (args.kernel, args.size, args.mode) == ("cuda", 4096, "mxu")
    text = (DEPLOY / "Dockerfile.loadgen").read_text()
    assert ('ENTRYPOINT ["python", "-m", "kube_gpu_stats_tpu_torch.loadgen"]'
            in text)
    assert "USER 65532" in text
    assert "-devel" in text  # nvcc builds the kernel at first use


def test_no_asset_names_a_feature_the_port_lacks():
    """Flags and paths of the reference's push egress and TPU runtime
    appear nowhere in the port's assets (the hub is ported: its own
    manifest is held to the port's hub parser below)."""
    for name in MANIFESTS + ("Dockerfile", "Dockerfile.loadgen"):
        functional = _functional(name).lower()
        for needle in ("pushgateway", "remote-write", "spill",
                       "libtpu", "tpu_runtime", "gke-tpu", "google.com/tpu"):
            assert needle not in functional, (name, needle)


# -- the hub ---------------------------------------------------------------------

def _hub_docs():
    docs = load_yaml_docs("hub.yaml")
    return {doc["kind"]: doc for doc in docs}


def test_hub_manifest_parses_with_a_deployment_service_and_targets():
    docs = _hub_docs()
    assert set(docs) == {"ConfigMap", "Deployment", "Service"}
    assert "targets.txt" in docs["ConfigMap"]["data"]
    spec = docs["Deployment"]["spec"]["template"]["spec"]
    container = spec["containers"][0]
    assert container["image"] == _daemonset_spec()[1]["containers"][0][
        "image"]          # the DaemonSet image: the hub path has no torch
    assert container["livenessProbe"]["httpGet"]["path"] == "/healthz"
    assert container["readinessProbe"]["httpGet"]["path"] == "/readyz"
    assert docs["Service"]["spec"]["ports"][0]["port"] == 9401
    assert docs["Service"]["spec"]["publishNotReadyAddresses"] is True


def test_every_hub_argument_parses_through_the_ports_hub(monkeypatch):
    from kube_gpu_stats_tpu_torch import hub

    container = _hub_docs()["Deployment"]["spec"]["template"]["spec"][
        "containers"][0]
    args = container["args"]
    assert args[0] == "hub"
    for flag in ("--targets-file", "--listen-port", "--interval",
                 "--ingest-checkpoint"):
        assert flag in args
    mounts = {m["mountPath"] for m in container["volumeMounts"]}
    assert args[args.index("--targets-file") + 1].rsplit("/", 1)[0] in mounts
    assert args[args.index("--ingest-checkpoint") + 1].rsplit("/", 1)[0] \
        in mounts
    seen = {}

    class Stop(Exception):
        pass

    def fake_hub(targets, **kwargs):
        seen.update(kwargs)
        raise Stop

    monkeypatch.setattr(hub, "file_targets_provider",
                        lambda path, static=(): lambda: [])
    monkeypatch.setattr(hub, "Hub", fake_hub)
    with pytest.raises(Stop):
        hub.main(args[1:])
    assert seen["interval"] == 10.0
    assert seen["ingest_checkpoint"] == "/var/lib/kube-tpu-stats/ingest.ckpt"
