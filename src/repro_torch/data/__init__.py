"""Data substrate of the port.

``stream``      bounded-memory DataStream over continuous+discrete columns
``synthetic``   seeded generators (GMM, drift, naive Bayes, factor analysis)
"""
