"""Voxel-grid operators of the port: plane sweeps (gsweep, sweep), CCL,
EDT, crop argmax, shortest-path fields and hole filling."""
