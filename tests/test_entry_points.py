"""The card-only entry points refuse to run without a GPU: no result
line, a non-zero exit, on the CPU here and in a directory that holds
chip_smoke.py alone."""

import os
import shutil
import subprocess
import sys

import pytest

from tests.conftest import REPO


def _run(args, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_fails_without_a_gpu(script):
    out = _run([script], REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "Mpaths/s" not in out.stdout
    assert "needs a GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_main_path_needs_only_jax_numpy_and_the_stdlib(tmp_path):
    """`import rustic` and a DarkCornell render to PNG through the CLI
    work with Pillow, flax, imageio and matplotlib made unimportable
    (ml_dtypes comes with jax)."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('PIL', 'flax', 'imageio', 'matplotlib'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from rustic.cli import main\n"
        f"sys.exit(main(['render', {os.path.join(REPO, 'assets', 'scenes', 'DarkCornell.glb')!r},"
        f" '--out', {str(tmp_path / 'c.png')!r}, '--spp', '1', '--size', '8x8',"
        " '--bounces', '1', '--stats-json', '']))\n"
    )
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    from rustic.utils.png import decode_png

    assert decode_png((tmp_path / "c.png").read_bytes()).shape == (8, 8, 3)


# the package's former name: the one package directory beside `rustic`
ALIAS = next(
    d for d in sorted(os.listdir(REPO))
    if d.startswith("rustic_") and os.path.isfile(os.path.join(REPO, d, "__init__.py"))
)


def test_former_package_name_is_an_alias():
    import importlib

    import rustic
    import rustic.cli
    import rustic.scene.world

    assert importlib.import_module(ALIAS) is rustic
    assert importlib.import_module(ALIAS + ".cli") is rustic.cli
    world = importlib.import_module(ALIAS + ".scene.world")
    assert world is rustic.scene.world
    assert world.__spec__.name == "rustic.scene.world"


def test_former_package_name_renders_to_png(tmp_path):
    """`python -m <former name>.cli render` writes a DarkCornell PNG
    with Pillow and flax unimportable."""
    code = (
        "import runpy, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('PIL', 'flax'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"sys.argv = ['cli', 'render', {os.path.join(REPO, 'assets', 'scenes', 'DarkCornell.glb')!r},"
        f" '--out', {str(tmp_path / 'c.png')!r}, '--spp', '1', '--size', '8x8',"
        " '--bounces', '1', '--stats-json', '']\n"
        f"runpy.run_module({ALIAS + '.cli'!r}, run_name='__main__', alter_sys=True)\n"
    )
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    from rustic.utils.png import decode_png

    assert decode_png((tmp_path / "c.png").read_bytes()).shape == (8, 8, 3)
