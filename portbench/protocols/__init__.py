"""Protocol adapters: one module a protocol, named by a configuration's
"protocol" key. Each defines Protocol(config, seed, device) with setup(),
request(k), prove(inputs), elements(proof), expected(k, zk=True) and
close(), and the port's phase spans that bound its layers: TOP_PHASES, the
spans directly inside prove(), and MSM_PHASES, the MSM's among them."""
