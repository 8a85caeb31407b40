"""The benchmark's own library: manifest, traffic generator, harness, check, readers."""
