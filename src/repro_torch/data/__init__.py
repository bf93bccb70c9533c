"""Data substrate of the port.

``stream``      bounded-memory DataStream over continuous+discrete columns
``synthetic``   seeded generators (GMM, drift, naive Bayes, factor analysis)
                and ground-truth networks (random discrete, CLG tree)
"""
