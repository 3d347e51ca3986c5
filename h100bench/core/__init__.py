"""The harness core: manifest, traffic generator, trace reduction, peaks."""
