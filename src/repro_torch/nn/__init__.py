"""The language-model substrate of the port (counterpart of ``repro.nn``).

``layers``       norms, embeddings, RoPE, gated MLPs
``attention``    GQA attention: oracle, blockwise (the plain version of the
                 ``flash_attention`` kernel), ring-buffer decode
``ssm``          Mamba2 SSD block (``ssd_chunked``: the plain version of the
                 ``ssd_scan`` kernel) and its one-token decode
``transformer``  model assembly, ``forward`` and ``decode_step``
"""
