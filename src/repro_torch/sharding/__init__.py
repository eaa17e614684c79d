"""Multi-device code: partition rules, the mesh and its collectives, explicit SPMD layouts."""
