"""The paper's technique applied to NN training (counterpart of
``repro.bayes``).

``vb_optimizer``   streaming variational Bayes over network weights:
                   Gaussian mean-field posterior, natural-gradient (VON)
                   updates, Eq.-3 prior chaining.
``drift``          streaming concept-drift monitor on the training loss.
"""
