#!/usr/bin/env bash
# Install kube-tpu-stats-h100 as a systemd service on a bare-metal H100
# host (a DGX or HGX server outside Kubernetes).
#
#   sudo kube_gpu_stats_tpu_torch/deploy/systemd/install.sh   # from a checkout
#
# Installs the package for the system python3, builds the host fast paths
# into the installed package (the unit's user cannot build under a
# read-only install, and a failed build stops the exporter at start),
# lays down the unit + env file, and starts the service. Idempotent:
# re-running upgrades in place.

set -euo pipefail

HERE="$(cd "$(dirname "$0")" && pwd)"
REPO="$(cd "${HERE}/../../.." && pwd)"

if [[ "$(id -u)" -ne 0 ]]; then
    echo "error: must run as root (installs a system service)" >&2
    exit 1
fi

if ! command -v nvidia-smi >/dev/null; then
    echo "error: nvidia-smi not found: install the NVIDIA driver first" >&2
    exit 1
fi

echo ">> installing package"
PIP_LOG="$(mktemp)"
trap 'rm -f "${PIP_LOG}"' EXIT
if ! python3 -m pip install --quiet "${REPO}" 2>"${PIP_LOG}"; then
    # Only a PEP 668 refusal justifies overriding the distro-managed
    # environment; any other failure surfaces verbatim.
    if grep -q "externally-managed-environment" "${PIP_LOG}"; then
        python3 -m pip install --quiet --break-system-packages "${REPO}"
    else
        cat "${PIP_LOG}" >&2
        exit 1
    fi
fi

echo ">> building the host fast paths (g++, zlib)"
# Run from / so the checkout cannot shadow the installed package: the
# unit imports the installed copy, so that is where the library goes.
(cd / && python3 -m kube_gpu_stats_tpu_torch.native._hostbuild)

echo ">> installing unit + default env"
install -m 0644 "${HERE}/kube-tpu-stats-h100.service" /etc/systemd/system/
if [[ ! -f /etc/default/kube-tpu-stats-h100 ]]; then
    install -m 0644 "${HERE}/kube-tpu-stats-h100.env" /etc/default/kube-tpu-stats-h100
else
    echo "   (keeping existing /etc/default/kube-tpu-stats-h100)"
fi

echo ">> starting service"
systemctl daemon-reload
systemctl enable --now kube-tpu-stats-h100.service
systemctl --no-pager --lines 0 status kube-tpu-stats-h100.service || true

echo ">> preflight (with the service's own environment)"
(
    set -a
    # shellcheck disable=SC1091
    [[ -f /etc/default/kube-tpu-stats-h100 ]] && . /etc/default/kube-tpu-stats-h100
    set +a
    cd / && kube-tpu-stats-h100 doctor --backend nvml
) || echo "   (doctor reported failures; see rows above)"
echo "done — scrape http://$(hostname):9400/metrics"
