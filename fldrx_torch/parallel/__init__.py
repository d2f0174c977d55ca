"""Multi-device evaluation and data-parallel training of the port
(counterpart of fldrx/parallel)."""
