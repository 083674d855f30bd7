"""The model families of ``repro.models``: configs, parameter specs, layers
with the blockfloat8 KV codec, ``DenseLM`` and ``MoELM`` (``transformer``,
``moe``), ``RWKV6LM`` (``rwkv6``), ``HymbaLM`` (``hybrid``) and
``EncDecLM`` (``encdec``)."""
