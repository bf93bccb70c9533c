"""Training side of the port (counterpart of ``repro.train``).

``optimizer``   AdamW with the cosine schedule, SGD with momentum
``step``        lm_loss, loss_fn, train_step, vb_train_step, serve_step
``trainer``     Trainer: the fit loop, drift response, checkpoints
``checkpoint``  the flat-key npz format both packages read
"""
