"""The LM substrate's models, the counterpart of ``repro.models``:
transformer blocks and blockwise attention (``layers``), Mamba-2 SSD
(``mamba2``), mixture-of-experts (``moe``), the architecture-dispatching
:class:`~repro_torch.models.model.Lm` with forward / prefill / decode
(``model``), and ``convert``, between repro's stacked parameter tree and
the port's modules (the tests, the checkpoint format and the sharding
rules speak repro's tree)."""
