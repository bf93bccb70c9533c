"""Command-line entry points of the port (counterpart of ``repro.launch``).

  mesh        DeviceMesh construction for d-VMP (host and production)
  dryrun_pgm  d-VMP's collective count a sweep, at N and 4N instances
  serve       LM serving from the command line
"""
