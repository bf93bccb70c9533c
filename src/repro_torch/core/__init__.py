"""Core of the port: the streaming-VMP learning engine.

  expfam     conjugate exponential-family algebra
  dag        Variables/DAG/CPDs/BayesianNetwork (the model language) and
             PlateSpec (the plate family the engine compiles)
  vmp        variational message passing on one device
  svi        natural coordinates (used by the drift tempering)
  streaming  Bayesian updating (Eq. 3), drift detection, quarantine
"""
