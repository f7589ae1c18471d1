# Developer entry points for rustic.

.PHONY: test test-fast bench native render-demo clean

test:
	python -m pytest tests/ -x -q

test-fast:
	python -m pytest tests/ -x -q -m "not slow"

bench:
	python bench.py

native:
	./native/build.sh

render-demo:
	python -m rustic.cli render assets/scenes/DarkCornell.glb \
		--out cornell.png --spp 128 --nee mis --tonemap aces_narkowicz

clean:
	rm -rf native/libbvh.so .pytest_cache
	find . -name __pycache__ -type d -exec rm -rf {} +
