"""The language-model substrate of the port (counterpart of ``repro.nn``).

``layers``       norms, embeddings, RoPE, learned positions, gated MLPs
``attention``    GQA attention: oracle, blockwise (the plain version of the
                 ``flash_attention`` kernel), ring-buffer decode
``ssm``          Mamba2 SSD block (``ssd_chunked``: the plain version of the
                 ``ssd_scan`` kernel) and its one-token decode
``moe``          mixture of experts: fp32 top-k routing, capacity dispatch
``transformer``  model assembly, ``forward`` and ``decode_step``
"""
