"""The H100 exporter's deployment assets: the images, the raw manifests,
the Prometheus rule files, the PodMonitors, the Grafana board, the Helm
chart and the bare-host systemd unit. :mod:`.assets` holds the tables
that say how they differ from the reference project's."""
