"""Core of the port: the learning and approximate-inference engine.

  expfam              conjugate exponential-family algebra
  dag                 Variables/DAG/CPDs/BayesianNetwork (the model
                      language) and PlateSpec (the plate family the engine
                      compiles)
  vmp                 variational message passing on one device
  dvmp                d-VMP: VMP over the data shards of a DeviceMesh,
                      one all-reduce of the suff-stats a sweep
  svi                 natural coordinates and the SVI optimizer
  streaming           Bayesian updating (Eq. 3), drift detection, quarantine
  factored_frontier   filtering / smoothing in factorial 2TBNs
  importance_sampling likelihood weighting in CLG networks
  map_inference       MAP of the discrete variables by batched hill climbing
"""
