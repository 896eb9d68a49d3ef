"""The port's entry points per layout: one module per layout, found by the configuration's model.layout."""
