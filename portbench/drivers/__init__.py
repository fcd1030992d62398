"""Traffic drivers: one module a traffic kind, named by a traffic file's
"kind" key, each with run(protocol, traffic, seconds, recorder)."""
