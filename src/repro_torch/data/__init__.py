"""Data substrate of the port.

``stream``      bounded-memory DataStream over continuous+discrete columns
``io``          ARFF loader and writer (static and dynamic streams)
``synthetic``   seeded generators (GMM, drift, naive Bayes, regression,
                factor analysis, sequences, LDA corpora) and ground-truth
                networks (random discrete, CLG tree)
"""
