"""Model runtime of the port: GQA + dense/MoE decoder blocks."""
