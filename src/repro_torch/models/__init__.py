"""The LM side of the port: configuration dataclasses (``config``), layer
primitives (``layers``), the feed-forward and attention blocks (``mlp``,
``attention``), the Mamba2 block (``ssm``) and the mLSTM / sLSTM blocks
(``xlstm``), model assembly and prefill (``transformer``) and the
single-token decode step (``decode``).  The dense, hybrid (zamba2) and
xLSTM families run; the MoE, audio and VLM families raise naming the
slice that brings them."""
