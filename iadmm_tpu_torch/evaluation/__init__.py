"""Residuals and objective of a solve."""
