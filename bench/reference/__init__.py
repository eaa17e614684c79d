"""Plain PyTorch references, one module a ``model_type``: the
architecture's forward pass over one sequence in float32 (TF32 off), one
block at a time with that block's weights upcast when it runs, attention
in blocks of queries.  They read the benchmark's weights by name and
import nothing of the port."""
