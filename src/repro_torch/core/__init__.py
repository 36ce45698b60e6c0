"""Ranking core of the port: discounts, sort assignment, the online
rank+audit oracle and the KNN shadow-price predictor."""
