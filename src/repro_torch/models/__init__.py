"""Models of the port (counterpart of repro.models): the paper's
Appendix-B recommender, which builds the experiment's utilities and
covariates, the four recsys backbones and the transformer LM family."""
