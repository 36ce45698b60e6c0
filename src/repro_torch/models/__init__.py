"""Models of the port (counterpart of repro.models): the paper's
Appendix-B recommender, which builds the experiment's utilities and
covariates."""
