"""Copy of columbiaimagesearch_tpu/store/storer.py:1-197 (boto3 imported
lazily).

Pickled-blob storers: local disk, in-memory, and S3.

Same surface as the reference's storer package
(reference: cufacesearch/storer/generic_storer.py:5-78, storer/local.py:9-128,
storer/s3.py:21-205): ``save``/``load``/``delete``/``list_prefix``/
``get_all_from_prefix``. boto3 is imported lazily; S3Storer accepts an
injected bucket so its logic is covered by a stub-client contract test.
"""

import io
import os
import pickle


class GenericStorer:
    def save(self, key, obj):
        raise NotImplementedError()

    def load(self, key, silent=True):
        raise NotImplementedError()

    def delete(self, key):
        raise NotImplementedError()

    def list_prefix(self, prefix=""):
        raise NotImplementedError()

    def get_all_from_prefix(self, prefix=""):
        for key in self.list_prefix(prefix):
            yield key, self.load(key)


class LocalStorer(GenericStorer):
    """Pickle files under a base directory (reference: storer/local.py)."""

    def __init__(self, base_path="./storer_data"):
        self.base_path = base_path
        os.makedirs(self.base_path, exist_ok=True)

    def _path(self, key):
        safe = key.replace("/", "__")
        return os.path.join(self.base_path, safe + ".pkl")

    def save(self, key, obj):
        with open(self._path(key), "wb") as f:
            pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)

    def load(self, key, silent=True):
        try:
            with open(self._path(key), "rb") as f:
                return pickle.load(f)
        except FileNotFoundError:
            if silent:
                return None
            raise

    def delete(self, key):
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def list_prefix(self, prefix=""):
        safe = prefix.replace("/", "__")
        for name in sorted(os.listdir(self.base_path)):
            if name.startswith(safe) and name.endswith(".pkl"):
                yield name[:-4].replace("__", "/")


class MemoryStorer(GenericStorer):
    """Dict-backed storer for tests and ephemeral runs."""

    def __init__(self):
        self._data = {}

    def save(self, key, obj):
        self._data[key] = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)

    def load(self, key, silent=True):
        if key not in self._data:
            if silent:
                return None
            raise KeyError(key)
        return pickle.loads(self._data[key])

    def delete(self, key):
        self._data.pop(key, None)

    def list_prefix(self, prefix=""):
        return iter(sorted(k for k in self._data if k.startswith(prefix)))


class S3Storer(GenericStorer):
    """S3 pickled-blob storer (reference: storer/s3.py:21-205).

    Surface-parity with the reference: optional in-bucket ``aws_prefix``
    folder, ``pickling`` raw-buffer mode (save accepts a bytes buffer, load
    returns a seeked BytesIO), prefix listing and prefix bulk-load. A
    pre-built ``bucket`` (or boto3 ``session``) can be injected, which both
    enables the stub-client contract test and supports pre-configured
    sessions in production.
    """

    def __init__(self, bucket_name=None, aws_region=None, aws_profile=None,
                 aws_prefix="", pickling=True, verbose=0, session=None,
                 bucket=None):
        self.bucket_name = bucket_name
        self.region = aws_region
        self.aws_profile = aws_profile
        self.aws_prefix = aws_prefix
        self.pickling = bool(pickling)
        self.verbose = verbose
        self.pp = "S3Storer"
        self.session = session
        self.s3 = None
        if bucket is not None:
            self.bucket = bucket
        else:
            if bucket_name is None:
                raise ValueError("S3Storer needs bucket_name or bucket")
            self.setup()

    def setup(self):
        """Open the session and check the bucket is reachable
        (reference: storer/s3.py:52-67)."""
        import boto3  # lazy: not part of the base image

        if self.session is None:
            self.session = boto3.Session(profile_name=self.aws_profile,
                                         region_name=self.region)
        self.s3 = self.session.resource("s3")
        self.s3.meta.client.head_bucket(Bucket=self.bucket_name)
        self.bucket = self.s3.Bucket(self.bucket_name)
        if self.verbose > 0:
            print(f"[{self.pp}: log] Initialized with bucket "
                  f"'{self.bucket_name}' profile '{self.aws_profile}' "
                  f"region '{self.region}'.")

    def _full_key(self, key):
        return "/".join([self.aws_prefix, key]) if self.aws_prefix else key

    def _strip_prefix(self, key):
        """(reference: storer/s3.py:69-81 _get_s3obj_key_noprefix)"""
        if self.aws_prefix and key.startswith(self.aws_prefix + "/"):
            return key[len(self.aws_prefix) + 1:]
        return key

    def save(self, key, obj):
        """(reference: storer/s3.py:84-105)"""
        if self.pickling:
            buf = io.BytesIO(
                pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
        elif isinstance(obj, (bytes, bytearray)):
            buf = io.BytesIO(obj)
        else:
            buf = obj  # assume file-like, reference raw mode
        self.bucket.upload_fileobj(buf, self._full_key(key))
        if self.verbose > 2:
            print(f"[{self.pp}: log] Saved file: {self._full_key(key)}")

    def load(self, key, silent=True):
        """(reference: storer/s3.py:107-146; returns None when missing)"""
        buf = io.BytesIO()
        try:
            self.bucket.download_fileobj(self._full_key(key), buf)
        except Exception as inst:
            if silent:
                if self.verbose > 1:
                    print(f"[{self.pp}: error ({type(inst).__name__})] "
                          f"Could not load object with key: {key}")
                return None
            raise
        buf.seek(0)
        if self.pickling:
            return pickle.load(buf)
        return buf

    def delete(self, key):
        self.bucket.delete_objects(
            Delete={"Objects": [{"Key": self._full_key(key)}]})

    def list_prefix(self, prefix=""):
        """Yield keys (aws_prefix stripped, matching LocalStorer's contract;
        reference: storer/s3.py:148-172 yields raw S3 objects)."""
        for obj in self.bucket.objects.filter(Prefix=self._full_key(prefix)):
            yield self._strip_prefix(obj.key)


def get_storer(storer_type, base_path=None, **kwargs):
    """Factory (reference: storer/generic_storer.py:5-33)."""
    if storer_type == "local":
        return LocalStorer(base_path or "./storer_data")
    elif storer_type == "memory":
        return MemoryStorer()
    elif storer_type == "s3":
        return S3Storer(**kwargs)
    raise ValueError(f"[get_storer: error] unknown storer type {storer_type}")
