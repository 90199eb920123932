"""The LM substrate: configs, layers, GQA attention, MoE, the transformer."""
