"""The LM side of the port: configuration dataclasses (``config``), layer
primitives (``layers``), the feed-forward and attention blocks (``mlp``,
``attention``), model assembly and prefill (``transformer``) and the
single-token decode step (``decode``).  This slice carries the dense
family; the hybrid, xLSTM, MoE, audio and VLM families raise naming the
slice that brings them."""
