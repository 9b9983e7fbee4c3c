# Dataset fetchers (parity with the reference Makefile's `download`
# target, /root/reference/Makefile:1-14). These need network egress;
# in sealed environments benchmarks fall back to synthetic corpora.

DATA ?= data

download: $(DATA)
	curl -L -o $(DATA)/wiki-news-300d-1M.vec.zip \
	  https://dl.fbaipublicfiles.com/fasttext/vectors-english/wiki-news-300d-1M.vec.zip
	unzip -o $(DATA)/wiki-news-300d-1M.vec.zip -d $(DATA)

download-sift: $(DATA)
	curl -L -o $(DATA)/sift.tar.gz ftp://ftp.irisa.fr/local/texmex/corpus/sift.tar.gz
	tar -xzf $(DATA)/sift.tar.gz -C $(DATA)

download-glove: $(DATA)
	curl -L -o $(DATA)/glove.6B.zip https://nlp.stanford.edu/data/glove.6B.zip
	unzip -o $(DATA)/glove.6B.zip -d $(DATA)

$(DATA):
	mkdir -p $(DATA)

native:
	g++ -O3 -shared -fPIC -std=c++17 vers_tpu/native/io_native.cpp \
	  -o vers_tpu/native/libversio.so

# quick tier: skips the `slow`-marked wave-build / partitioned /
# subprocess-dryrun tests. `test-all` is the full pyramid.
test:
	python -m pytest tests/ -x -q -m "not slow"

test-all:
	python -m pytest tests/ -x -q

bench:
	python bench.py

# Rehearse the end-to-end commands: bench.py -> multichip dryrun.
# Each step fails loudly on rc != 0.
preflight:
	python bench.py
	python -c "import __graft_entry__ as g; g.dryrun_multichip(8); \
	print('dryrun_multichip(8) ok')"
	@echo "preflight green"

# The card's smoke test (one GPU); `smoke-4` runs the sharded phase on
# four GPUs.
smoke:
	python chip_smoke.py

smoke-4:
	python chip_smoke.py --four-cards

.PHONY: download download-sift download-glove native test test-all bench preflight smoke smoke-4
