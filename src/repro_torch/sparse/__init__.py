"""The sparse dispatch layer: planner, activations, weights, tape,
dispatch, conv, sites."""
