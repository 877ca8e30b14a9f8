"""Single-device bundle, iteration engine, driver and Problem API."""
