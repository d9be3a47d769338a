"""The sparse dispatch layer: planner, activations, weights, tape, dispatch, sites."""
